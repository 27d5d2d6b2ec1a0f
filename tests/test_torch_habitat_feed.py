"""The port's ``runtime/habitat_feed.py`` against the JAX package's, both
driven by ``tests/habitat_sim_stub.py`` (habitat's pose conventions,
sliding collision, pose-keyed RGBA / depth renders) patched into each
module as ``habitat_sim``:

* one action script (a turn, a wall hit, a slide, STOP, the candidate
  RPCs, the pose override, a 12-view panorama, ``feeds_from_episode_file``)
  gives equal observations and equal ``_info`` dicts, exactly;
* without ``habitat_sim`` both constructors raise ``ImportError``;
* a 2-step ``EpisodeRunner.run`` of the tiny slice config over the feed
  emits the JAX runner's ids and action texts from the same weights.
"""

import json
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dynam3d_tpu.runtime import habitat_feed as jhf
from dynam3d_tpu.runtime.feed import STOP as JSTOP
from dynam3d_torch.runtime import habitat_feed as thf
from dynam3d_torch.runtime.feed import STOP as TSTOP
from tests import habitat_sim_stub as stub


@pytest.fixture(autouse=True)
def _patch_habitat(monkeypatch):
    monkeypatch.setattr(jhf, "habitat_sim", stub)
    monkeypatch.setattr(thf, "habitat_sim", stub)


def _episode(start=(4.0, 0.0, -3.4), heading=0.3, goal=(6.5, 0.0, -6.0)):
    return {
        "start_position": list(start),
        "heading": heading,
        "goals": [{"position": list(goal)}],
        "instruction": {"instruction_text": "walk to the far corner"},
    }


def _feeds(views=1, rgb=24, depth=16, **kw):
    return (jhf.HabitatFeed("stub_scene.glb", _episode(**kw), rgb_size=rgb, depth_size=depth,
                            views=views),
            thf.HabitatFeed("stub_scene.glb", _episode(**kw), rgb_size=rgb, depth_size=depth,
                            views=views))


def _assert_obs_equal(t, j):
    for name in ("rgb", "depth", "position"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert t.heading == j.heading and t.instruction == j.instruction


def _both(jfeed, tfeed, fn):
    return fn(jfeed), fn(tfeed)


def test_quaternion_helpers_equal():
    for h in (0.0, 0.3, 1.1, math.pi, 5.9):
        np.testing.assert_array_equal(thf.heading_to_quat(h), jhf.heading_to_quat(h))
        q = jhf.heading_to_quat(h)
        assert thf.quat_to_heading(q) == jhf.quat_to_heading(q)


def test_action_script_equal_exactly():
    """Turn + walk, a head-on wall hit (counted), a 45-degree slide along
    the wall (not counted), STOP, then the candidate RPCs and the pose
    override, every observation and info dict equal."""
    jf, tf = _feeds(heading=0.0)
    _assert_obs_equal(*reversed(_both(jf, tf, lambda f: f.reset())))
    script = [(0.0, 0.5), (0.0, 0.5), (0.25 * math.pi, 0.25), (0.7, 0.8), (-0.4, 0.25)]
    collisions = []
    for action in script:
        (jo, jd, ji), (to, td, ti) = _both(jf, tf, lambda f: f.step(action))
        _assert_obs_equal(to, jo)
        assert td == jd and ti == ji
        collisions.append(ti["collisions"])
    # the second move hits the strip at z = -4 head on, the third slides
    assert collisions[:3] == [0, 1, 1]
    (jo, jd, ji), (to, td, ti) = jf.step(JSTOP), tf.step(TSTOP)
    assert jd and td and ti == ji
    _assert_obs_equal(to, jo)
    for angle, fwd in ((0.4, 1.0), (-1.2, 0.75), (2.0, 3.0)):
        jc, tc = _both(jf, tf, lambda f: f.get_cand_real_pos(angle, fwd))
        np.testing.assert_array_equal(tc, jc)
        assert tf.cand_dist_to_goal(angle, fwd) == jf.cand_dist_to_goal(angle, fwd)
    assert tf.oracle_distance() == jf.oracle_distance()
    assert tf.oracle_distance(np.float32([50.0, 0.0, 1.0])) == jf.oracle_distance(
        np.float32([50.0, 0.0, 1.0])) == 1e6
    probe = (np.float32([2.0, 0.0, -6.5]), 1.9)
    _assert_obs_equal(tf.get_observation(*probe), jf.get_observation(*probe))
    np.testing.assert_array_equal(tf._get_state().position, jf._get_state().position)
    assert tf._heading == jf._heading
    assert tf._info() == jf._info()
    jf.close()
    tf.close()
    assert jf._sim.closed and tf._sim.closed


def test_panorama_and_start_rotation_equal():
    ep = _episode(heading=0.9)
    del ep["heading"]
    ep["start_rotation"] = list(jhf.heading_to_quat(0.9))
    jf = jhf.HabitatFeed("s.glb", ep, rgb_size=12, depth_size=8, views=12)
    tf = thf.HabitatFeed("s.glb", ep, rgb_size=12, depth_size=8, views=12)
    jo, to = jf.reset(), tf.reset()
    assert to.rgb.shape == (12, 12, 12, 3) and to.depth.shape == (12, 8, 8)
    _assert_obs_equal(to, jo)
    (jo, _, ji), (to, _, ti) = jf.step((0.3, 0.5)), tf.step((0.3, 0.5))
    _assert_obs_equal(to, jo)
    assert ti == ji
    assert tf._heading == jf._heading


def test_feeds_from_episode_file_equal(tmp_path):
    eps = {"episodes": [{
        "episode_id": i, "scene_id": "sceneA/sceneA.glb",
        "start_position": [4.0, 0.0, -1.0 - i],
        "start_rotation": list(jhf.heading_to_quat(0.4 + i)),
        "instruction": {"instruction_text": f"episode {i}"},
        "reference_path": [[4.0, 0.0, -1.0], [6.0, 0.0, -5.0]],
        "goals": [{"position": [6.0, 0.0, -5.0]}],
    } for i in range(2)]}
    p = tmp_path / "val_seen.json"
    p.write_text(json.dumps(eps))
    jfs = jhf.feeds_from_episode_file(str(p), str(tmp_path), rgb_size=8, depth_size=8)
    tfs = thf.feeds_from_episode_file(str(p), str(tmp_path), rgb_size=8, depth_size=8)
    assert len(tfs) == len(jfs) == 2
    for jf, tf in zip(jfs, tfs):
        assert tf._sim.config.sim_cfg.scene_id == jf._sim.config.sim_cfg.scene_id
        _assert_obs_equal(tf.reset(), jf.reset())
        (jo, _, ji), (to, _, ti) = jf.step((0.2, 0.5)), tf.step((0.2, 0.5))
        _assert_obs_equal(to, jo)
        assert ti == ji


def test_without_habitat_sim_both_raise(monkeypatch):
    monkeypatch.setattr(jhf, "habitat_sim", None)
    monkeypatch.setattr(thf, "habitat_sim", None)
    with pytest.raises(ImportError, match="HabitatFeed needs habitat-sim"):
        jhf.HabitatFeed("s.glb", _episode())
    with pytest.raises(ImportError, match="HabitatFeed needs habitat-sim"):
        thf.HabitatFeed("s.glb", _episode())


def test_episode_over_the_feed_emits_the_jax_texts():
    """A 2-step tiny-config episode on the stub-backed feeds (56² RGBA cut
    to RGB, 32² depth over 10 m): the port's runner on the CPU emits the
    JAX runner's ids and action texts from the same weights."""
    from dynam3d_tpu.models import policy as jpolicy
    from dynam3d_tpu.runtime.episode import EpisodeRunner as JRunner
    from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
    from tests.torch_parity import port_config, slice_config, to_torch

    jcfg = slice_config()
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    jf, tf = _feeds(rgb=56, depth=32, start=(4.0, 0.0, -1.0), heading=0.3)

    jr = JRunner(jp, jcfg)
    jgens, step = [], jr._full_step

    def capture(*a, **k):
        st, g = step(*a, **k)
        jgens.append(np.asarray(g)[0].tolist())
        return st, g

    jr._full_step = capture
    jres = jr.run([jf], max_steps=2, ignore_stop=True)
    tr = TRunner(to_torch(jp), port_config(jcfg), device="cpu")
    tres = tr.run([tf], max_steps=2, ignore_stop=True)

    assert len(jgens) == len(tr.step_log) == 2
    for s, jg in zip(tr.step_log, jgens):
        assert s["gen"] == jg, (s["step"], s["gen"], jg)
        text = jr.tok.decode(jg)
        text = text[: text.find("<|end|>")] if "<|end|>" in text else text
        assert s["text"] == text
    assert tres[0]["steps"] == jres[0]["steps"] == 2
    assert tres[0]["distance_to_goal"] == jres[0]["distance_to_goal"]
    assert tres[0]["position"] == jres[0]["position"]
