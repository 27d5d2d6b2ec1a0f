"""SS-ETP pretraining through ``run.main`` on two gloo ranks (the CPU):
``train.iters=2`` at ``train.seed=6``, whose shared draws take the walk
corpus, then the unposed frames corpus (``tests/torch_dist.py::ss_etp_run``
records each iteration's update, one spawn for the file).

* both ranks draw the same dataset ids; their scenes and walks differ;
* after each iteration the ranks' trained trees are bit-identical;
* the frames iteration equals one process's mean-loss update over the two
  ranks' batches, and the walk iteration one process's update from the mean
  of the ranks' episode-mean gradients: the mean loss within 1e-5
  relative, each parameter within 1e-6, save that Adam's early steps
  (``lr * m / (sqrt(v) + 1e-8)``) turn a mean gradient within float noise
  of zero into a move of up to the learning rate either way: at most 0.1%
  of a leaf's elements may differ by more, none by more than 1.01 x the
  learning rate (as ``test_torch_dist_train.py``'s pretraining step);
* rank 0 alone writes the checkpoint (the ranks' final tree, exactly) and
  the metrics log.
"""

import json
import os

import numpy as np
import pytest
import torch

from dynam3d_torch import config as tcfg
from dynam3d_torch.models.memory3d import init_state
from dynam3d_torch.parallel.spawn import run_ranks
from dynam3d_torch.runtime import checkpoint as ckpt_mod
from dynam3d_torch.runtime import trainer_3dff as t3
from dynam3d_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from tests import torch_dist
from tests.test_torch_run_cli import OPTS, _pretrain_config, _write_config

SEED = 6
OVERRIDES = OPTS[1:] + [f"train.seed={SEED}", "train.iters=2", "train.log_every=2",
                        "train.pretrain_traj_len=2"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("pre")
    cfg_path = _write_config(work / "cfg.json", _pretrain_config())
    argv = ["--exp-config", cfg_path, "--run-type", "train", "--trainer", "SS-ETP",
            "--exp_name", "pre"] + OVERRIDES
    ranks = run_ranks(torch_dist.ss_etp_run, 2, args=(str(work), argv), timeout=300)
    cfg = tcfg.apply_opts(tcfg.load(cfg_path), OVERRIDES)
    return dict(ranks=ranks, cfg=cfg, work=work)


def _assert_close(got, want, lr):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        err = (g - w).abs()
        assert float((err > 1e-6).float().mean()) <= 1e-3, (i, float(err.max()))
        assert float(err.max()) <= 1.01 * lr, (i, float(err.max()))


def _identical(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_ranks_draw_the_same_datasets(world):
    r0, r1 = world["ranks"]
    assert [r["dataset"] for r in r0] == [r["dataset"] for r in r1] == [0, 1]
    assert [r["kind"] for r in r0] == ["walk", "frames"]
    assert not _identical(r0[0]["grad_sum"], r1[0]["grad_sum"])
    assert not torch.equal(r0[1]["batch"][0], r1[1]["batch"][0])


def test_trees_bit_identical_after_each_iteration(world):
    r0, r1 = world["ranks"]
    for a, b in zip(r0, r1):
        assert _identical(a["before"], b["before"]) and _identical(a["after"], b["after"])
        assert not _identical(a["before"], a["after"])


def test_walk_equals_the_mean_gradient_update(world):
    cfg, (a, b) = world["cfg"], (r[0] for r in world["ranks"])
    mean = tree_map(lambda x, y: (x / a["n_steps"] + y / b["n_steps"]) / 2, a["grad_sum"],
                    b["grad_sum"])
    want, _ = t3.apply_accumulated_grads(t3.make_pretrain_optimizer(cfg), a["before"], a["opt"],
                                         mean, 1)
    _assert_close(a["after"], want, cfg.train.pretrain_lr)


def test_frames_equal_the_mean_loss_update(world):
    cfg, (a, b) = world["cfg"], (r[1] for r in world["ranks"])
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(a["before"])]
    tr = tree_unflatten(a["before"], leaves)
    losses = [t3.pretrain_step_loss(tr, cfg, init_state(cfg.fields, "cpu"),
                                    t3.PretrainBatch(*r["batch"]), posed=r["posed"])[0]
              for r in (a, b)]
    loss = torch.stack(losses).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else torch.nan_to_num(g, nan=0.0)
             for g, p in zip(grads, leaves)]
    updates, _ = t3.make_pretrain_optimizer(cfg).update(grads, a["opt"], a["before"])
    want = tree_unflatten(a["before"], [p + u for p, u in zip(tree_leaves(a["before"]),
                                                              updates)])
    np.testing.assert_allclose(a["loss"], float(loss.detach()), rtol=1e-5)
    assert a["loss"] == b["loss"]
    _assert_close(a["after"], want, cfg.train.pretrain_lr)


def test_rank_zero_alone_saves_and_logs(world):
    work = world["work"]
    assert os.listdir(work / "data/checkpoints") == ["ckpt.iter2"]
    ck = ckpt_mod.load_checkpoint(str(work / "data/checkpoints/ckpt.iter2"))
    assert _identical(ck, world["ranks"][0][1]["after"])
    rows = [json.loads(r) for r in (work / "data/logs/pre/scalars.jsonl").open()]
    assert sorted({r["step"] for r in rows}) == [0, 1]
    assert len(rows) == len({(r["step"], r["tag"]) for r in rows})   # one writer
