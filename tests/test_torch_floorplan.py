"""The port's ``FloorplanFeed``, ``RecordedEpisodeFeed`` and the
``record_episodes`` / ``make_golden_fixtures`` tools against the JAX
package's (numpy on the host in both, so every comparison is exact unless
a tolerance is stated).

* ``FloorplanFeed``: the BFS field equal; ``_ray`` on the graze,
  free-parallel and start-in-wall cases within 1e-9; observations,
  ``info``, collisions, ``oracle_distance``, ``cand_dist_to_goal``,
  ``get_cand_real_pos`` and ``get_observation`` bit for bit over a scripted
  action sequence that hits a wall.
* ``RecordedEpisodeFeed`` on both committed fixtures: the same
  observations, infos and oracle distances as the reference's replay.
* ``make_golden_fixtures`` into a temporary directory: both files equal to
  the reference's recipe run here.
* both fixtures through each package's ``evaluate``: the same stats files.
"""

import json
import os
import sys

import numpy as np
import pytest

from dynam3d_tpu.runtime import feed as jfeed
from dynam3d_torch.runtime import feed as tfeed
from dynam3d_torch.tools import make_golden_fixtures as tgolden
from dynam3d_torch.tools import record_episodes as trecord

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GRAZE_PLAN = ("S...", "..#.", "...G")


def _assert_obs_equal(a, b):
    np.testing.assert_array_equal(a.rgb, b.rgb)
    np.testing.assert_array_equal(a.depth, b.depth)
    np.testing.assert_array_equal(a.position, b.position)
    assert a.heading == b.heading and a.instruction == b.instruction


def test_bfs_field_and_goal_equal():
    t, j = tfeed.FloorplanFeed(rgb_size=8, depth_size=8), jfeed.FloorplanFeed(rgb_size=8,
                                                                               depth_size=8)
    np.testing.assert_array_equal(t._dist_field, j._dist_field)
    np.testing.assert_array_equal(t.grid, j.grid)
    np.testing.assert_array_equal(t.goal, j.goal)
    assert t.start == j.start
    assert np.isfinite(t._dist_field).sum() == (~t.grid).sum()     # every free cell reached
    gx, gz = 14, 3
    np.testing.assert_array_equal(t._bfs_field(gx, gz), j._bfs_field(gx, gz))
    with pytest.raises(ValueError, match="not connected"):
        tfeed.FloorplanFeed(plan=("S#G",), rgb_size=8, depth_size=8)


def test_ray_cases_match():
    t = tfeed.FloorplanFeed(plan=GRAZE_PLAN, cell_size=0.5, rgb_size=8, depth_size=8)
    j = jfeed.FloorplanFeed(plan=GRAZE_PLAN, cell_size=0.5, rgb_size=8, depth_size=8)
    d = np.hypot(0.95, 0.05)
    cases = {
        "perpendicular": ((0.75, 0.75, 1.0, 0.0), 0.25),
        "graze": ((0.5, 0.45, 0.95 / d, 0.05 / d), d),
        "free_parallel": ((0.75, 0.25, 1.0, 0.0), t.max_depth),
        "start_in_wall": ((1.2, 0.75, 1.0, 0.0), 0.0),
    }
    for name, (args, want) in cases.items():
        got = t._ray(*args)
        assert abs(got - want) < 1e-9, (name, got, want)
        assert abs(got - j._ray(*args)) < 1e-9, name
    rng = np.random.default_rng(0)
    for _ in range(200):
        x, z = rng.uniform(0, 2.0), rng.uniform(0, 1.5)
        a = rng.uniform(0, 2 * np.pi)
        assert t._ray(x, z, np.cos(a), np.sin(a)) == j._ray(x, z, np.cos(a), np.sin(a))
    assert t._is_wall(1.2, 0.75) and not t._is_wall(0.2, 0.2)
    assert t._cell(-3.0, 99.0) == j._cell(-3.0, 99.0)


# a scripted walk of the default apartment: moves, a huge move into a wall,
# turns, then STOP
ACTIONS = [(0.0, 0.75), (np.pi / 2, 1.5), (np.pi, 100.0), (-0.6, 0.25), (2.0, 1.0),
           (0.0, 0.0), (4.5, 3.0), tfeed.STOP]


@pytest.mark.parametrize("views", [1, 3])
def test_scripted_episode_matches(views):
    t = tfeed.FloorplanFeed(rgb_size=24, depth_size=16, views=views, seed=3)
    j = jfeed.FloorplanFeed(rgb_size=24, depth_size=16, views=views, seed=3)
    _assert_obs_equal(t.reset(), j.reset())
    collided = 0
    for a in ACTIONS:
        for ang, fwd in ((0.0, 0.75), (1.3, 1.5), (3.0, 40.0)):
            assert t.cand_dist_to_goal(ang, fwd) == j.cand_dist_to_goal(ang, fwd)
            np.testing.assert_array_equal(t.get_cand_real_pos(ang, fwd),
                                          j.get_cand_real_pos(ang, fwd))
        (ot, dt, it), (oj, dj, ij) = t.step(a), j.step(a)
        _assert_obs_equal(ot, oj)
        assert dt == dj and it == ij
        assert t.oracle_distance() == j.oracle_distance()
        collided = it["collisions"]
    assert collided >= 1                                  # the wall hit was counted
    assert dt is True
    p = np.float32([6.2, 1.25, 1.7])
    assert t.oracle_distance(p) == j.oracle_distance(p)
    assert t.oracle_distance(np.float32([0.1, 1.25, 0.1])) == 1e6   # a wall cell
    _assert_obs_equal(t.get_observation(p, 0.9), j.get_observation(p, 0.9))


@pytest.mark.parametrize("name", ["golden_box_ep.npz", "golden_floorplan_ep.npz"])
def test_recorded_replay_matches(name):
    path = os.path.join(FIXTURES, name)
    t, j = tfeed.RecordedEpisodeFeed(path), jfeed.RecordedEpisodeFeed(path)
    assert t.instruction == j.instruction
    np.testing.assert_array_equal(t.gt_locations, j.gt_locations)
    np.testing.assert_array_equal(t.goal, j.goal)
    _assert_obs_equal(t.reset(), j.reset())
    n = len(t.rgb)
    for k in range(n + 1):
        action = tfeed.STOP if k == n else (0.3, 0.25)
        (ot, dt, it), (oj, dj, ij) = t.step(action), j.step(action)
        _assert_obs_equal(ot, oj)
        assert dt == dj and it == ij
        assert t.oracle_distance() == j.oracle_distance()
    assert dt and len(it["position"]) == n
    assert t.oracle_distance(t.position[0]) == j.oracle_distance(j.position[0])


def test_record_matches_the_reference_tool(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from record_episodes import record as jrecord
    finally:
        sys.path.pop(0)

    def teacher(feed):
        return lambda obs, t: tfeed.STOP if t == 3 else (0.4 * t, 0.75)

    ft, fj = (m.SyntheticRoomFeed(rgb_size=16, depth_size=8, seed=2) for m in (tfeed, jfeed))
    assert trecord.record(ft, teacher(ft), 6, str(tmp_path / "t.npz")) == 4
    assert jrecord(fj, teacher(fj), 6, str(tmp_path / "j.npz")) == 4
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_make_golden_fixtures_matches_the_reference_recipe(tmp_path):
    """The port's tool and the reference's recipe (same feeds, seeds, sizes
    and greedy teacher, run here with the JAX feeds) write the same files.
    The box file also equals the committed fixture.  The committed floorplan
    fixture predates the exact DDA ray of ``FloorplanFeed._ray`` and no
    longer matches any run of the recipe, so it is not compared."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from make_golden_fixtures import greedy_teacher
        from record_episodes import record as jrecord
    finally:
        sys.path.pop(0)

    tgolden.main(["--out", str(tmp_path / "torch")])
    jdir = tmp_path / "jax"
    jdir.mkdir()
    box = jfeed.SyntheticRoomFeed(rgb_size=56, depth_size=32, seed=11)
    jrecord(box, greedy_teacher(box), 12, str(jdir / "golden_box_ep.npz"))
    flo = jfeed.FloorplanFeed(rgb_size=56, depth_size=32, seed=12)
    jrecord(flo, greedy_teacher(flo), 24, str(jdir / "golden_floorplan_ep.npz"))
    for name in ("golden_box_ep.npz", "golden_floorplan_ep.npz"):
        a, b = np.load(tmp_path / "torch" / name), np.load(jdir / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(name, k))
    a, c = np.load(tmp_path / "torch" / "golden_box_ep.npz"), np.load(
        os.path.join(FIXTURES, "golden_box_ep.npz"))
    assert sorted(a.files) == sorted(c.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    flo_t = np.load(tmp_path / "torch" / "golden_floorplan_ep.npz")
    assert float(np.linalg.norm(flo_t["position"][-1, [0, 2]] - flo_t["goal"][[0, 2]])) < 1.5


def test_tools_require_an_output_directory():
    with pytest.raises(SystemExit):
        tgolden.main([])
    with pytest.raises(SystemExit):
        trecord.main([])


def test_recorded_fixtures_through_evaluate(tmp_path):
    """Both committed episodes replayed through each package's ``evaluate``
    (tiny slice config, float32 Phi-3, ``ignore_stop`` so each replay runs
    to the end of its recording) write the same stats files."""
    import jax
    import jax.numpy as jnp

    from dynam3d_tpu.models import policy as jpolicy
    from dynam3d_tpu.runtime import vln_loop as jloop
    from dynam3d_torch.runtime import vln_loop as tloop
    from tests.torch_parity import port_config, slice_config, to_torch

    jcfg = slice_config()
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    names = ("golden_box_ep.npz", "golden_floorplan_ep.npz")
    for name, mod, loop, params, cfg, kw in (
            ("jax", jfeed, jloop, jp, jcfg, {}),
            ("torch", tfeed, tloop, to_torch(jp), port_config(jcfg), {"device": "cpu"})):
        feeds = [mod.RecordedEpisodeFeed(os.path.join(FIXTURES, n)) for n in names]
        gt = [np.asarray(f.gt_locations, np.float32) for f in feeds]
        loop.evaluate(params, cfg, feeds, gt, out_dir=str(tmp_path / name), ckpt_name="golden",
                      ignore_stop=True, **kw)
    for f in ("stats_golden.json", "stats_ep_golden_r0_w1.json"):
        assert (tmp_path / "torch" / f).read_text() == (tmp_path / "jax" / f).read_text()
    per_ep = json.loads((tmp_path / "torch" / "stats_ep_golden_r0_w1.json").read_text())
    # each replay is done on reaching the last of its 5 and 9 recorded frames
    assert [per_ep[k]["steps_taken"] for k in ("0", "1")] == [4.0, 8.0]
