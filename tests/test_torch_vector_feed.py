"""The port's ``VectorFeedPool``: forkserver workers behind the Feed
protocol, as ``tests/test_vector_feed.py`` holds the reference's pool.

A pool of two workers (8² frames) against the same feeds in process: the
same observations, dones and infos; the oracle RPCs; data attributes
fetched by value; a worker error surfaces; every response is drained
after a failure; and ``EpisodeRunner`` over the pool's proxies decodes the
same action texts as over in-process feeds."""

import functools

import numpy as np
import pytest
import torch

from dynam3d_torch.runtime.feed import STOP, FloorplanFeed, SyntheticRoomFeed
from dynam3d_torch.runtime.vector_feed import VectorFeedPool

FACTORIES = [
    functools.partial(FloorplanFeed, rgb_size=8, depth_size=8, seed=1),
    functools.partial(FloorplanFeed, rgb_size=8, depth_size=8, seed=2, views=2),
]


@pytest.fixture(scope="module")
def pool():
    with VectorFeedPool(FACTORIES) as p:
        yield p


def _obs_equal(a, b):
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.depth, b.depth)
    np.testing.assert_array_equal(a.position, b.position)
    assert a.heading == b.heading and a.instruction == b.instruction


def test_pool_matches_inprocess_feeds(pool):
    local = [f() for f in FACTORIES]
    for op, ol in zip(pool.reset(), [f.reset() for f in local]):
        _obs_equal(op, ol)
    for acts in ([(0.3, 0.5), (1.2, 0.25)], [(np.pi, 100.0), (0.0, 0.75)], [STOP, (0.5, 1.0)]):
        out_p = pool.step(acts)
        out_l = [f.step(a) for f, a in zip(local, acts)]
        for (op, dp, ip), (ol, dl, il) in zip(out_p, out_l):
            _obs_equal(op, ol)
            assert dp == dl and ip == il
    assert out_p[0][1] is True and out_l[0][2]["collisions"] == 1   # STOP; the wall hit


def test_proxy_oracle_rpcs(pool):
    proxy, local = pool.feeds[1], FACTORIES[1]()
    proxy.reset(), local.reset()
    for ang, fwd in ((0.5, 0.75), (2.0, 30.0)):
        assert proxy.cand_dist_to_goal(ang, fwd) == local.cand_dist_to_goal(ang, fwd)
        np.testing.assert_array_equal(proxy.get_cand_real_pos(ang, fwd),
                                      local.get_cand_real_pos(ang, fwd))
    p = np.float32([3.0, 1.25, 3.0])
    _obs_equal(proxy.get_observation(p, 0.7), local.get_observation(p, 0.7))
    assert proxy.oracle_distance(p) == local.oracle_distance(p)


def test_proxy_data_attributes_fetch_values(pool):
    proxy, local = pool.feeds[0], FACTORIES[0]()
    assert isinstance(proxy.instruction, str) and proxy.instruction == local.instruction
    np.testing.assert_array_equal(proxy.goal, local.goal)
    assert proxy.views == 1 and pool.feeds[1].views == 2
    assert callable(proxy.cand_dist_to_goal)
    proxy.reset()
    proxy.step((0.0, 0.25))
    assert len(proxy.positions) == 2          # re-fetched after the step


def test_worker_error_surfaces(pool):
    with pytest.raises(AttributeError):
        pool.feeds[0].no_such_method
    assert getattr(pool.feeds[0], "no_such_attr", None) is None
    with pytest.raises(RuntimeError, match="TypeError"):
        pool.feeds[0].step()                   # missing the action


def test_pool_drains_responses_after_worker_failure(pool):
    pool.reset()
    with pytest.raises(RuntimeError, match="feed worker 0"):
        pool.call("step", [(), ((0.1, 0.25),)])
    out = pool.step([(0.2, 0.25), (0.3, 0.25)])
    local = FACTORIES[1]()
    local.reset()
    local.step((0.1, 0.25))
    obs_l, _, info_l = local.step((0.3, 0.25))
    _obs_equal(out[1][0], obs_l)
    assert out[1][2] == info_l


def test_episode_runner_over_pool():
    """``EpisodeRunner.run`` over pooled proxies of two feeds decodes the
    same texts, step for step, as over the same feeds in process."""
    from dynam3d_torch import config as tconfig
    from dynam3d_torch.models import policy
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.tools.eval_soak import soak_config

    cfg = soak_config("tiny")
    cfg = tconfig.apply_opts(cfg, ["segmenter.provider=depth_plane", "fields.encoder_dtype=f32",
                                   "clip.compute_dtype=f32"])
    params = policy.init_policy_params(0, cfg, llm_dtype=torch.float32, device="cpu")
    factories = [functools.partial(FloorplanFeed, rgb_size=56, depth_size=32, seed=0),
                 functools.partial(SyntheticRoomFeed, rgb_size=56, depth_size=32, seed=1)]

    def texts(feeds):
        runner = EpisodeRunner(params, cfg, device="cpu")
        res = runner.run(feeds, max_steps=2, ignore_stop=True)
        return [r["steps"] for r in res], [s["texts"] for s in runner.step_log]

    with VectorFeedPool(factories) as p:
        pooled = texts(p.feeds)
    local = texts([f() for f in factories])
    assert pooled == local
    assert pooled[0] == [2, 2]
