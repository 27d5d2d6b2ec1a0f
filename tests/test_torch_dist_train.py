"""Data-parallel training of the port on two gloo ranks (the CPU), against
the JAX package on one device (``tests/torch_dist.py::dp_train``, one spawn
for the file, and the dry run's four ranks):

* the IL step, one row a rank, against the JAX ``make_train_step`` on the
  2-row batch (tiny slice config, float32, lr 1e-3): loss and global norm
  within 1e-4 relative, the updated trainable leaves as in
  ``test_torch_vln_step.py`` (within 1e-4 of the update's size, at most
  0.1% of a leaf's elements of opposite sign), both ranks' trees bit for
  bit the same;
* a NaN loss on one rank: both ranks skip (parameters and optimizer count
  as they were);
* the pretraining step, one scene a rank (the reference test batch and a
  second one), against the mean-loss step of ``_dryrun_pretrain_dp``: the
  mean loss within 1e-5 relative, the parameters within
  ``test_torch_pretrain_step.py``'s tolerances, save that Adam's first step
  (``lr * g / (|g| + 1e-8)``) turns a mean gradient within float noise of
  zero into a move of up to the learning rate either way: at most 0.1% of
  a leaf's elements may differ by more, and none by more than the learning
  rate;
* ``VLNTrainer.train`` with a 1-step episode on one rank and 3-step
  episodes on the other: both finish, with bit-identical trainable trees;
  the same when one rank's episode ends on an ``"error."`` teacher label
  (a looping episode) while the other's goes on;
* ``gather_list_and_concat`` at 1 and 2 ranks; ``run.main(device="cpu")``
  at ``WORLD_SIZE = 2`` for one iteration (rank 0's checkpoint);
* ``dryrun_multichip(4)`` prints its five ``OK`` lines;
* the launch scripts ``dynam3d_torch/scripts/*.sh`` pass the reference
  scripts' arguments to ``dynam3d_torch.run`` under ``torch.distributed.run``
  (torchrun) with ``NPROC`` ranks (``python`` stubbed to print its argv).
"""

import dataclasses
import os
import subprocess
from pathlib import Path

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp

from dynam3d_tpu.config import Dynam3DConfig
from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.runtime import trainer_3dff as jtr
from dynam3d_tpu.runtime import trainer_vln as jtv
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_tpu.runtime.vln_loop import VLNTrainer as JTrainer
from dynam3d_torch.parallel.dryrun import dryrun_multichip
from dynam3d_torch.parallel.spawn import run_ranks
from dynam3d_torch.runtime import checkpoint as ckpt_mod
from dynam3d_torch.utils.misc import gather_list_and_concat
from tests import torch_dist
from tests.test_pretrain import FCFG, batch_and_params  # noqa: F401  (fixture)
from tests.test_torch_pretrain import _jax_paths, batch_to_torch
from tests.test_torch_run_cli import OPTS, _write_config
from tests.torch_parity import np32, port_config, slice_config

ROOT = Path(__file__).resolve().parents[1]
GT = "turn right 3 steps, move 2 steps.<|end|>"
HIST = ["none\n", "none\n", "move 2 steps.\n", "turn left 1 steps, move 1 steps.\n"]


def _il_world():
    jcfg = slice_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=1e-3, use_waypoint_predictor=False))
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    jt = JTrainer(jp, jcfg, lambda: None)
    obs = [JFeed(rgb_size=56, depth_size=32, views=1, seed=s).reset() for s in (2, 3)]
    ids, tv, lab, lm = (np.asarray(a) for a in jt._tokenize_full(obs[0].instruction, HIST, GT))

    def row(o, tw):
        return (o.rgb[None], o.depth[None], np.float32(o.position)[None],
                np.float32([o.heading]), ids.astype(np.int64), tv, lab.astype(np.int64), lm,
                np.float32([tw]))

    rows = [row(o, 1.0) for o in obs]
    nan_rows = [rows[0], row(obs[1], float("nan"))]
    jbatch = jtv.TrainBatch(*(jnp.asarray(np.concatenate([r[i] for r in rows]))
                              for i in range(9)))
    jstep = jax.jit(jtv.make_train_step(jcfg, jt.optimizer, jt.splice_start))
    jtr0 = _jax_paths(jax.tree_util.tree_map(np.array, jt.trainable))
    jnew, jopt, _, jmet = jstep(jt.trainable, jt.frozen, jt.opt_state,
                                jpolicy.batched_init_state(jcfg, 2), jbatch)
    il_in = (port_config(jcfg), jax.tree_util.tree_map(np.asarray, jp), jt.splice_start, rows,
             nan_rows)
    return il_in, {"tr0": jtr0, "tr": _jax_paths(jnew), "m": jmet, "count": int(jopt[0].count)}


def _pre_world(params, batch):
    jcfg = Dynam3DConfig(fields=dataclasses.replace(FCFG, encoder_dtype="f32"))
    rng = np.random.default_rng(9)
    batch2 = batch._replace(
        grid_fts=jnp.asarray(rng.normal(size=batch.grid_fts.shape).astype(np.float32)),
        cls_fts=jnp.asarray(rng.normal(size=batch.cls_fts.shape).astype(np.float32)),
        novel_gt_fts=jnp.asarray(rng.normal(size=batch.novel_gt_fts.shape).astype(np.float32)))
    jopt = jtr.make_pretrain_optimizer(jcfg)

    @jax.jit
    def mean_step(tr, opt_state):
        def loss_fn(t):
            losses = [jtr.pretrain_step_loss(t, jcfg, jm.init_state(jcfg.fields), b)[0]
                      for b in (batch, batch2)]
            return jnp.mean(jnp.stack(losses))

        loss, grads = jax.value_and_grad(loss_fn)(tr)
        updates, _ = jopt.update(grads, opt_state, tr)
        return optax.apply_updates(tr, updates), loss

    jnew, jloss = mean_step(params, jopt.init(params))
    tb = [tuple(None if t is None else t.numpy() for t in batch_to_torch(b))
          for b in (batch, batch2)]
    pre_in = (port_config(jcfg), jax.tree_util.tree_map(np.asarray, params), tb)
    return pre_in, {"tr": _jax_paths(jnew), "loss": float(jloss),
                    "tr0": _jax_paths(jax.tree_util.tree_map(np.array, params))}


@pytest.fixture(scope="module")
def world(batch_and_params, tmp_path_factory):
    il_in, il_ref = _il_world()
    pre_in, pre_ref = _pre_world(*batch_and_params)
    lcfg = slice_config()
    lcfg = port_config(dataclasses.replace(lcfg, train=dataclasses.replace(
        lcfg.train, lr=1e-3, use_waypoint_predictor=False, max_traj_len=3)))
    # start (2, 2): a goal 0.7 m away stops at once, one 5.7 m away does not
    lock_in = (lcfg, [(2.5, 2.5), (6.0, 6.0)])
    work = tmp_path_factory.mktemp("cli")
    cfg_path = _write_config(work / "cfg.json", slice_config())
    argv = (["--exp-config", cfg_path, "--run-type", "train", "--exp_name", "dp"] + OPTS +
            ["train.max_traj_len=2", "train.iters=1", "train.log_every=1",
             "train.use_waypoint_predictor=false"])
    ranks = run_ranks(torch_dist.dp_train, 2, args=(il_in, pre_in, lock_in, (str(work), argv)),
                      timeout=300)
    return dict(il=il_ref, pre=pre_ref, ranks=ranks, work=work)


def test_dp_il_step_equals_the_two_row_step(world):
    ref, ranks = world["il"], world["ranks"]
    for r in ranks:
        s = r["step"]
        assert not s["skipped"] and not bool(ref["m"]["skipped"]) and s["count"] == 1
        np.testing.assert_allclose(s["loss"], float(ref["m"]["loss"]), rtol=1e-4)
        np.testing.assert_allclose(s["grad_norm"], float(ref["m"]["grad_norm"]), rtol=1e-4)
    a, b = ranks[0]["trained"], ranks[1]["trained"]
    assert sorted(a) == sorted(ref["tr"]) and all(np.array_equal(a[k], b[k]) for k in a)
    for name, p0 in ref["tr0"].items():
        ju = np.asarray(ref["tr"][name], np.float64) - p0
        tu = a[name].astype(np.float64) - p0
        assert np.abs(ju).max() > 0 and np.abs(tu).max() > 0, name
        flipped = np.sign(ju) * np.sign(tu) < 0
        assert flipped.mean() <= 0.001, (name, flipped.mean())
        np.testing.assert_allclose(tu[~flipped], ju[~flipped], rtol=0,
                                   atol=1e-4 * np.abs(ju).max(), err_msg=name)


def test_nan_on_one_rank_skips_the_update_on_both(world):
    for r in world["ranks"]:
        n = r["nan"]
        assert np.isnan(n["loss"]) and n["skipped"] and n["count"] == 0 and n["unchanged"]


def test_dp_pretrain_step_equals_the_mean_loss_step(world):
    ref, ranks = world["pre"], world["ranks"]
    D = FCFG.fts_dim
    a, b = ranks[0]["pre_trained"], ranks[1]["pre_trained"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    moved = 0.0
    for r in ranks:
        np.testing.assert_allclose(r["pre_loss"], ref["loss"], rtol=1e-5)
    lr = 1e-5
    for name, got in a.items():
        want = np32(ref["tr"][name])
        tol = np.full(want.shape, 1e-6, np.float32)
        if name.endswith("attn/qkv/b"):
            tol[D:2 * D] = 2e-5
        err = np.abs(got - want)
        assert (err > tol).mean() <= 1e-3 and (err <= 1.01 * lr).all(), (
            name, (err > tol).mean(), err.max())
        moved += float(np.abs(got - np32(ref["tr0"][name])).sum())
    assert moved > 0


def test_unequal_episodes_finish_in_lockstep(world):
    short, long_ = (r["lock"] for r in world["ranks"])
    assert short["steps"] == [0, 0] and long_["steps"] == [0, 1, 2, 0, 1, 2]
    assert short["idle"] == 4 and long_["idle"] == 0
    for k, v in short["trained"].items():
        np.testing.assert_array_equal(v, long_["trained"][k], err_msg=k)


def test_error_label_on_one_rank_keeps_the_lockstep(world):
    looped, live = (r["error"] for r in world["ranks"])
    assert looped["steps"] == [0] and looped["idle"] == 2
    assert live["steps"] == [0, 1, 2] and live["idle"] == 0
    for k, v in looped["trained"].items():
        np.testing.assert_array_equal(v, live["trained"][k], err_msg=k)


def test_gather_list_and_concat_at_one_and_two_ranks(world):
    rows = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(gather_list_and_concat(rows), rows)
    for rank, r in enumerate(world["ranks"]):
        np.testing.assert_array_equal(r["gathered"], [[0, 0], [1, 1], [1, 1]])
        np.testing.assert_array_equal(r["ungrouped"], [[rank, rank]])


def test_run_main_trains_data_parallel(world):
    path = world["work"] / "data" / "checkpoints" / "ckpt.iter1"
    assert os.listdir(path.parent) == ["ckpt.iter1"]
    ck = ckpt_mod.load_checkpoint(str(path))
    assert sorted(ck) == ["opt_state", "trainable"] and ck["opt_state"]["count"] >= 1


def test_dryrun_multichip_prints_five_lines(capsys):
    lines = dryrun_multichip(4, device="cpu", timeout=300)
    out = capsys.readouterr().out.splitlines()
    assert lines == out[-5:] and len(lines) == 5
    for line, head in zip(lines, ("dryrun_multichip OK: mesh dp=2 tp=2", "dryrun generate OK",
                                  "dryrun decode-fallback OK", "dryrun pretrain OK: dp=2",
                                  "dryrun eval-agg OK")):
        assert line.startswith(head), line


@pytest.mark.parametrize("name", ["train_vln.sh", "eval_vln.sh", "pretrain_3dff.sh"])
def test_launch_scripts_pass_the_reference_arguments(name, tmp_path):
    stub = tmp_path / "python"
    stub.write_text('#!/bin/sh\necho "$@"\n')
    stub.chmod(0o755)
    env = {**os.environ, "PATH": f"{tmp_path}:{os.environ['PATH']}", "NPROC": "2"}

    def argv(script):
        assert os.access(script, os.X_OK), script
        return subprocess.run(["bash", str(script), "exp1", "train.iters=3"], env=env,
                              capture_output=True, text=True, check=True).stdout.split()

    ref = argv(ROOT / "scripts" / name)
    got = argv(ROOT / "dynam3d_torch" / "scripts" / name)
    assert ref[:2] == ["-m", "dynam3d_tpu.run"]
    assert got[:4] == ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2"]
    assert got[4:6] == ["-m", "dynam3d_torch.run"] and got[6:] == ref[2:]
