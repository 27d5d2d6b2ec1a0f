"""Port parity of the host utilities: ``utils/follower.py``,
``utils/obs_transforms.py``, ``utils/misc.py`` (all but the cross-rank
gather), ``utils/visual.py`` and ``tools/check_tokenizer.py``.  Numpy and
Python on the same inputs, made from a seed: every output identical."""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest

from dynam3d_tpu.runtime import feed as jfeed
from dynam3d_tpu.utils import follower as jfollow
from dynam3d_tpu.utils import misc as jmisc
from dynam3d_tpu.utils import obs_transforms as jobs
from dynam3d_tpu.utils import visual as jvis
from dynam3d_torch.runtime import feed as tfeed
from dynam3d_torch.tools import check_tokenizer as tcheck
from dynam3d_torch.utils import follower as tfollow
from dynam3d_torch.utils import misc as tmisc
from dynam3d_torch.utils import obs_transforms as tobs
from dynam3d_torch.utils import visual as tvis

_spec = importlib.util.spec_from_file_location(
    "reference_check_tokenizer",
    os.path.join(os.path.dirname(__file__), "..", "tools", "check_tokenizer.py"))
jcheck = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jcheck)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# follower
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["room", "floorplan"])
def test_follower_walks_like_the_reference(kind):
    """``next_action`` / ``discrete_action`` step for step on the same feed
    in both packages (the feeds are bit for bit, ``test_torch_floorplan``):
    the same actions, poses and final distance."""
    def make(m):
        if kind == "room":
            return m.SyntheticRoomFeed(rgb_size=16, depth_size=8, seed=3, goal=(6.0, 2.5))
        return m.FloorplanFeed(rgb_size=16, depth_size=8)

    jf, tf = make(jfeed), make(tfeed)
    jf.reset()
    tf.reset()
    jfw = jfollow.ShortestPathFollower(goal_radius=1.0, turn_angle_deg=30.0)
    tfw = tfollow.ShortestPathFollower(goal_radius=1.0, turn_angle_deg=30.0)
    for _ in range(25):
        assert tfw.discrete_action(tf) == jfw.discrete_action(jf)
        ja, ta = jfw.next_action(jf), tfw.next_action(tf)
        assert ta == ja
        if ja == jfeed.STOP:
            assert ta == tfeed.STOP
            break
        cands = [(float(a), d) for a in np.linspace(0, 2 * math.pi, 7) for d in (0.5, 1.0)]
        assert tfw.next_action(tf, cands) == jfw.next_action(jf, cands)
        jo, jdone, _ = jf.step(ja)
        to, tdone, _ = tf.step(ta)
        _same(to.position, jo.position)
        assert to.heading == jo.heading and tdone == jdone
    _same(np.stack(tf.positions), np.stack(jf.positions))
    assert tf.headings == jf.headings and len(jf.positions) > 3
    assert tf.oracle_distance() == jf.oracle_distance()


# ---------------------------------------------------------------------------
# observation transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,crop,size", [((12, 16, 3), (8, 10), (5, 7)),
                                             ((2, 9, 9, 1), (4, 4), (18, 13)),
                                             ((3, 2, 10, 6, 4), (7, 5), (3, 3))])
def test_crop_and_resize_match_reference(shape, crop, size):
    img = np.random.default_rng(sum(shape)).integers(0, 255, shape).astype(np.uint8)
    _same(tobs.center_crop(img, crop), jobs.center_crop(img, crop))
    _same(tobs.resize_nearest(img, size), jobs.resize_nearest(img, size))
    obs = {"rgb": img, "depth": img[..., :1].astype(np.float32) / 255, "other": img}
    crops, resizes = {"rgb": crop, "missing": (1, 1)}, {"depth": size, "rgb": size}
    t, j = tobs.apply_per_sensor(obs, crops, resizes), jobs.apply_per_sensor(obs, crops, resizes)
    assert sorted(t) == sorted(j)
    for k in j:
        _same(t[k], j[k])
    assert tobs.apply_per_sensor(obs).keys() == obs.keys()


@pytest.mark.parametrize("face,out_hw", [(8, (16, 32)), (13, (21, 40))])
def test_cubemap_to_equirect_matches_reference(face, out_hw):
    rng = np.random.default_rng(face)
    faces = {k: rng.integers(0, 255, (face, face, 3)).astype(np.uint8) for k in "FRBLUD"}
    _same(tobs.cubemap_to_equirect(faces, out_hw), jobs.cubemap_to_equirect(faces, out_hw))
    ffaces = {k: v.astype(np.float32) / 7 for k, v in faces.items()}
    _same(tobs.cubemap_to_equirect(ffaces, out_hw), jobs.cubemap_to_equirect(ffaces, out_hw))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", ["turn left at the sofa, then stop.", "",
                                  "café → stairs \U0001f6aa " * 30])
def test_instruction_codec_matches_reference(text):
    for max_length, pad in ((200, 0), (16, 7)):
        ids = tmisc.encode_instruction(text, max_length, pad)
        _same(ids, jmisc.encode_instruction(text, max_length, pad))
        assert tmisc.decode_instruction(ids, pad) == jmisc.decode_instruction(ids, pad)


def test_misc_helpers_match_reference():
    rng = np.random.default_rng(21)
    for step in (0.25, 0.1, 1.7):
        path = rng.normal(size=(6, 3)) * 2
        path[3] = path[2]                                  # a zero-length segment
        _same(tmisc.densify_path(path, step), jmisc.densify_path(path, step))
    for n in (12, 8, 1):
        assert tmisc.camera_orientations(n) == jmisc.camera_orientations(n)
    h = rng.uniform(-7, 7, 17)
    _same(tmisc.angle_feature(h), jmisc.angle_feature(h))
    _same(tmisc.angle_feature(list(h[:3])), jmisc.angle_feature(list(h[:3])))
    lengths = rng.integers(1, 9, 6)
    for size in (None, 12):
        _same(tmisc.length2mask(lengths, size), jmisc.length2mask(lengths, size))


# ---------------------------------------------------------------------------
# visual
# ---------------------------------------------------------------------------
def test_top_down_map_matches_reference():
    rng = np.random.default_rng(5)
    bounds = (-3.0, 4.0, -2.0, 5.5)
    jm, tm = jvis.TopDownMap(bounds, 96), tvis.TopDownMap(bounds, 96)
    path = rng.uniform(-4, 6, (9, 2)).tolist()                # some points off the map
    for m, color in ((jm, jvis.GT_COLOR), (tm, tvis.GT_COLOR)):
        m.draw_path(path, color)
        m.draw_path(path[::-1])
        m.draw_goal(path[-1])
        m.draw_agent(path[0], 0.7)
    _same(tm.image(), jm.image())


@pytest.mark.parametrize("h", [64, 40])
def test_video_frames_match_reference(tmp_path, h):
    """``observations_to_image`` (with a map of another height),
    ``navigator_video_frame`` with and without gt path and bounds, and
    ``generate_video``'s frame stack (with ``imageio`` missing or present,
    as the reference: its mp4 when an encoder works, else none)."""
    rng = np.random.default_rng(h)
    rgb = rng.integers(0, 255, (h, 48, 3)).astype(np.uint8)
    td = rng.integers(0, 255, (96, 96, 3)).astype(np.uint8)
    _same(tvis.observations_to_image(rgb, td), jvis.observations_to_image(rgb, td))
    _same(tvis.observations_to_image(rgb), jvis.observations_to_image(rgb))
    pred = rng.uniform(-2, 2, (5, 2)).tolist()
    gt = rng.uniform(-2, 2, (4, 2)).tolist()
    frames = []
    for gt_path, goal, bounds in ((gt, gt[-1], None), (None, None, (-3.0, 3.0, -3.0, 3.0))):
        t = tvis.navigator_video_frame(rgb, pred, gt_path, goal, 1.1, bounds)
        _same(t, jvis.navigator_video_frame(rgb, pred, gt_path, goal, 1.1, bounds))
        frames.append(t)
    frames = [f[:, :144] for f in frames]
    jp = jvis.generate_video(frames, str(tmp_path / "j" / "vid"), fps=3)
    tp = tvis.generate_video(frames, str(tmp_path / "t" / "vid"), fps=3)
    assert os.path.basename(tp) == os.path.basename(jp)
    jz, tz = np.load(jp), np.load(tp)
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        _same(tz[k], jz[k])
    assert (os.path.exists(str(tmp_path / "t" / "vid.mp4"))
            == os.path.exists(str(tmp_path / "j" / "vid.mp4")))


# ---------------------------------------------------------------------------
# check_tokenizer
# ---------------------------------------------------------------------------
def test_check_tokenizer_matches_reference(tmp_path, capsys):
    """``build_fixture`` writes the same tokenizer, ``run_checks`` gives
    the same report on it (the port's ``HFTokenizer`` and ``build_prompt``
    against the reference's), and ``main --self-test`` the same output."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcheck.build_fixture(jdir)
    tcheck.build_fixture(tdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert b.read() == a.read(), name
    report = tcheck.run_checks(jdir)
    assert report == jcheck.run_checks(jdir)
    assert report["C1_single_token_image"]["ok"] and not report["all_ok"]
    capsys.readouterr()
    assert tcheck.main(["--self-test", "--json"]) == jcheck.main(["--self-test", "--json"]) == 0
    t_out, j_out = capsys.readouterr().out.splitlines()
    assert t_out == j_out and '"self_test_ok": true' in t_out
