"""Port parity of the hm3d walk driver (``runtime/pretrain_loop.py::
WalkDriver``): two episodes of ``PretrainRunner.run`` in both packages from
the same seed and parameters, on the walk tests' tiny config (12-view
``SyntheticRoomFeed``, 2 novel views a step, at most 3 steps).

Each feed's ``step`` is wrapped: both drivers take the same actions in the
same order (the host draws, the teacher's oracle and the heatmap sampling
agree), the same ``walk_steps``, metrics within 1e-4 relative, and the
trained ``fields`` and ``render`` within ``test_torch_pretrain_loop.py``'s
tolerances (two updates: Adam noise of up to 4e-5 either way in the
stated places)."""

import numpy as np

from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.runtime import pretrain_loop as tloop
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from tests.torch_parity import (
    assert_trained_close, port_config, to_torch, walk_config, walk_params,
)


def logged_feed(feed_cls, actions):
    """A 12-view feed whose ``step`` records its actions."""
    feed = feed_cls(rgb_size=56, depth_size=64, views=12, seed=7)
    step = feed.step

    def logged(action):
        actions.append(action)
        return step(action)

    feed.step = logged
    return feed


def walk_driver(mod, feed, cfg, **kw):
    return mod.WalkDriver(feed, mod.synthetic_supervision(0, cfg.fields.fts_dim), nv=2,
                          max_len=3, seed=5, **kw)


def test_walk_episodes_match_reference():
    jcfg = walk_config()
    jp = walk_params(jcfg, 4)
    jacts, tacts = [], []
    jrun = jloop.PretrainRunner(dict(jp), jcfg)
    jhist = jrun.run([walk_driver(jloop, logged_feed(JFeed, jacts), jcfg)], iters=2)
    trun = tloop.PretrainRunner(to_torch(jp), port_config(jcfg), device="cpu")
    thist = trun.run([walk_driver(tloop, logged_feed(TFeed, tacts), jcfg)], iters=2)

    assert tacts == jacts and len(jacts) >= 3
    assert any(a != -100 for a in jacts)
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j)
        assert t["walk_steps"] == j["walk_steps"] and 1 <= t["walk_steps"] <= 3
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert_trained_close(trun.params, jrun.params, jcfg.fields.fts_dim, noise=4e-5)
    assert [r["walk_steps"] for r in trun.timings] == [h["walk_steps"] for h in thist]
    assert all(r["walk_s"] >= r["grad_s"] > 0 for r in trun.timings)
