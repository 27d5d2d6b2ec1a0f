"""Eval and inference, pre-exploration, checkpoints and the HF
tokenizer adapter of the port, against the JAX package where it has a
counterpart (tiny slice config, float32 Phi-3, episodes of 3 steps).

* ``evaluate`` and ``inference`` (r2r and rxr) over the same feeds write
  the same files: the same JSON text (the greedy ids are identical on this
  config, ``test_torch_episode.py``, so the paths and every metric are).
* ``pre_explore``: the memory after 3 random steps has the same valid
  slots and owners, positions within 1e-4 and features within 1e-3 plus
  one bf16 step (the table stores bf16 features of float32 towers summed
  in another order).
* checkpoints: ``train`` writes ``ckpt.iter{N}``; ``resume`` restores the
  same tensors and optimizer state; ``poll_checkpoint_folder`` yields by
  mtime; ``run`` trains to ``cfg.train.iters`` and resumes when requeued.
* ``HFTokenizer`` on a tokenizer written to disk: the same ids, special
  ids and decoded text as the reference's adapter.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.runtime import episode as jepisode
from dynam3d_tpu.runtime import vln_loop as jloop
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime import checkpoint as tckpt
from dynam3d_torch.runtime import vln_loop as tloop
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from dynam3d_torch.utils.tree import tree_leaves
from tests.test_hf_tokenizer import tok_path  # noqa: F401  (fixture)
from tests.torch_parity import np32, port_config, slice_config, to_torch

GT_PATHS = [np.float32([[2.0, 1.25, 2.0], [6.0, 1.25, 6.0]]),
            np.float32([[2.0, 1.25, 2.0], [3.0, 1.25, 5.0], [6.0, 1.25, 6.0]])]


def _feeds(mod, n=2):
    return [mod(rgb_size=56, depth_size=32, views=1, seed=i) for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    jcfg = slice_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, max_traj_len=3, use_waypoint_predictor=False))
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    return jcfg, port_config(jcfg), jp, to_torch(jp)


@pytest.fixture(scope="module")
def output_files(setup, tmp_path_factory):
    """Both packages' eval and inference files; the reference's
    ``evaluate`` and ``inference`` share one runner, so its step compiles
    once."""
    jcfg, tcfg, jp, tp = setup
    out = tmp_path_factory.mktemp("outputs")
    shared = jepisode.EpisodeRunner(jp, jcfg)

    class Shared(jepisode.EpisodeRunner):
        def __new__(cls, *a, **k):
            return shared

    mp = pytest.MonkeyPatch()
    mp.setattr(jepisode, "EpisodeRunner", Shared)
    try:
        for name, mod, loop, params, kw in (("jax", JFeed, jloop, jp, {}),
                                            ("torch", TFeed, tloop, tp, {"device": "cpu"})):
            cfg = jcfg if name == "jax" else tcfg
            d = out / name
            loop.evaluate(params, cfg, _feeds(mod), GT_PATHS, out_dir=str(d), ckpt_name="c1",
                          ignore_stop=True, **kw)
            for fmt in ("r2r", "rxr"):
                loop.inference(params, cfg, _feeds(mod), ["ep0", "ep1"],
                               out_path=str(d / f"preds_{fmt}.json"), fmt=fmt, **kw)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["stats_c1.json", "stats_ep_c1_r0_w1.json",
                                  "preds_r2r.json", "preds_rxr.json"])
def test_output_files_are_identical(output_files, name):
    t = (output_files / "torch" / name).read_text()
    j = (output_files / "jax" / name).read_text()
    assert t == j
    if name == "stats_ep_c1_r0_w1.json":
        per_ep = json.loads(t)
        assert sorted(per_ep) == ["0", "1"]
        assert all(e["steps_taken"] == 3.0 for e in per_ep.values())
    if name == "preds_rxr.json":
        rows = [json.loads(r) for r in t.splitlines()]
        assert [r["instruction_id"] for r in rows] == ["ep0", "ep1"]


def test_evaluate_shards_by_rank(setup):
    _, tcfg, _, tp = setup
    feeds = _feeds(TFeed, 3)
    agg = tloop.evaluate(tp, tcfg, feeds, GT_PATHS + GT_PATHS[:1], rank=1, world=2,
                         device="cpu")
    assert set(agg) >= {"success", "spl", "ndtw", "sdtw", "oracle_success"}
    assert feeds[0].positions == [] and feeds[2].positions == []   # rank 1 of 2 runs feed 1


def test_pre_explore_state_matches(setup):
    jcfg, tcfg, jp, tp = setup
    jr = jepisode.EpisodeRunner(jp, jcfg)
    jst = jr.pre_explore(_feeds(JFeed, 1), jpolicy.batched_init_state(jcfg, 1), 3)
    tfeeds = _feeds(TFeed, 1)
    tr = TRunner(tp, tcfg, device="cpu")
    tst = tr.pre_explore(tfeeds, tpolicy.batched_init_state(tcfg, 1, "cpu"), 3)
    assert len(tfeeds[0].positions) == 1                # reset after the walk
    for name in ("patch_valid", "patch_owner", "inst_valid", "zone_valid"):
        np.testing.assert_array_equal(np32(getattr(tst, name)), np32(getattr(jst, name)),
                                      err_msg=name)
    assert int(np.asarray(jst.patch_valid).sum()) > 0
    np.testing.assert_allclose(np32(tst.patch_pos), np32(jst.patch_pos), atol=1e-4)
    np.testing.assert_allclose(np32(tst.patch_fts), np32(jst.patch_fts), rtol=2 ** -8, atol=1e-3)


def test_run_with_pre_explore_starts_from_the_walked_memory(setup):
    _, tcfg, _, tp = setup
    r = TRunner(tp, tcfg, device="cpu")
    res = r.run(_feeds(TFeed, 1), max_steps=1, pre_explore_steps=2, ignore_stop=True)
    assert res[0]["steps"] == 1


def _trainer(tcfg, tp, feeds):
    return tloop.VLNTrainer(tp, tcfg, lambda: feeds.append(TFeed(rgb_size=56, depth_size=32,
                                                                 seed=len(feeds))) or feeds[-1],
                            recycle_every=1, device="cpu")


def test_train_checkpoints_resume_and_poll(setup, tmp_path):
    jcfg, tcfg, jp, _ = setup
    feeds = []
    t1 = _trainer(tcfg, to_torch(jp), feeds)
    t1.train(iters=2, log_every=1, ckpt_dir=str(tmp_path))
    assert len(feeds) == 3                               # one feed, then one per episode
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt.iter1", "ckpt.iter2"]
    os.utime(tmp_path / "ckpt.iter1", (1, 1))            # the older by mtime
    newest = tckpt.newest_checkpoint(str(tmp_path))
    assert newest.endswith("ckpt.iter2") and tckpt.checkpoint_step(newest) == 2

    t2 = _trainer(tcfg, to_torch(jp), [])
    assert t2.resume(str(tmp_path)) == 2
    assert t2.opt_state["count"] == t1.opt_state["count"] == len(t1.step_log) > 0
    for a, b in zip(tree_leaves(t1.trainable), tree_leaves(t2.trainable)):
        assert torch.equal(a, b)
    for key in ("v_row", "v_col", "v"):
        for a, b in zip(tree_leaves(t1.opt_state[key]), tree_leaves(t2.opt_state[key])):
            assert torch.equal(a, b)
    assert tloop.VLNTrainer.resume(t2, str(tmp_path / "none")) == 0

    seen = set()
    got = list(tloop.poll_checkpoint_folder(str(tmp_path), seen, poll_s=0.01, timeout_s=0.05))
    assert [os.path.basename(g) for g in got] == ["ckpt.iter1", "ckpt.iter2"]
    assert list(tloop.poll_checkpoint_folder(str(tmp_path), seen, poll_s=0.01,
                                             timeout_s=0.02)) == []


def test_run_trains_to_iters_and_resumes_when_requeued(setup, tmp_path):
    """``run`` reads ``iters``, ``ckpt_dir``, ``log_every`` and
    ``is_requeue`` from ``cfg.train``: a first run trains ``iters``
    episodes and saves each; a requeued run resumes at ``iters`` with the
    same tensors and trains no more."""
    _, tcfg, jp, _ = setup
    cfg = dataclasses.replace(tcfg, train=dataclasses.replace(
        tcfg.train, iters=2, log_every=1, ckpt_dir=str(tmp_path / "ck")))
    t1 = _trainer(cfg, to_torch(jp), [])
    assert t1.run() == 0
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt.iter1", "ckpt.iter2"]
    assert t1._episodes_done == 2
    requeued = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, is_requeue=True))
    t2 = _trainer(requeued, to_torch(jp), [])
    assert t2.run() == 2 and t2._episodes_done == 0 and t2.step_log == []
    assert t2.opt_state["count"] == t1.opt_state["count"]
    for a, b in zip(tree_leaves(t1.trainable), tree_leaves(t2.trainable)):
        assert torch.equal(a, b)


def test_load_checkpoint_places_tensors_like_the_template(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 7, {"a": [torch.ones(2, dtype=torch.float64)],
                                                    "n": 3})
    assert os.path.basename(path) == "ckpt.iter7"
    out = tckpt.load_checkpoint(path, {"a": [torch.zeros(2, dtype=torch.bfloat16)], "n": 0})
    assert out["a"][0].dtype == torch.bfloat16 and out["n"] == 3
    assert tckpt.load_checkpoint(path)["a"][0].dtype == torch.float64


def test_hf_tokenizer_matches_the_reference(tok_path):  # noqa: F811
    from dynam3d_tpu.models.vlm.tokenizer import HFTokenizer as JTok, build_prompt
    from dynam3d_torch.models.vlm.tokenizer import HFTokenizer as TTok

    t, j = TTok(tok_path), JTok(tok_path)
    for attr in ("vocab_size", "pad_id", "bos_id", "end_id", "image_id"):
        assert getattr(t, attr) == getattr(j, attr), attr
    text = build_prompt("walk to the sofa.", ["none\n"] * 3 + ["turn left 1 steps, move 2 steps.\n"],
                        5, "stop.<|end|>")
    ids = t.encode(text)
    assert ids == j.encode(text) and ids.index(t.image_id) == 2
    assert t.encode("stop.", add_bos=False) == j.encode("stop.", add_bos=False)
    assert t.decode(ids) == j.decode(ids)
