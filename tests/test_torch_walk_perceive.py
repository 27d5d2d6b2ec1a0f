"""Port parity of the 3DFF panorama (``models/policy_3dff.py``) on the walk
tests' tiny config (float32 encoders and CLIP, depth encoder at 64 px):
``perceive_panorama`` folding two panoramas of a ``SyntheticRoomFeed`` in
turn (the second over the first's memory, so frustum deletion has work),
``waypoint_heatmap``, ``candidates_from_heatmap``,
``counter_clockwise_restore``, ``sample_waypoints_train``, and the walk
driver's forward fan when a heatmap gives no candidate.

Tolerances: memory tables and aux exact for ids and masks, 1e-4 for values
(as ``test_torch_pretrain.py``); CLIP CLS 1e-4; heatmap logits within 1e-4
of their scale (``test_torch_vln_waypoint.py``); the depth features of the
full-width ResNet-50 within 3e-4 of their scale (measured against a float64
evaluation: the JAX package's float32 within 5.5e-5, the port's 1.4e-4);
candidates identical, angles within an f32 ulp; the sampled bins equal for
the same seed, and the generators left in the same state."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.models import policy_3dff as jp3
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed
from dynam3d_torch.models import memory3d as tm
from dynam3d_torch.models import policy_3dff as tp3
from dynam3d_torch.models.memory3d.state import stack_states, unstack_state
from tests.test_torch_memory3d import _compare
from tests.torch_parity import np32, port_config, to_torch, walk_config, walk_params


@pytest.fixture(scope="module")
def setup():
    jcfg = walk_config()
    jp = walk_params(jcfg, 4)
    return jcfg, port_config(jcfg), jp, to_torch(jp)


def _panoramas():
    feed = SyntheticRoomFeed(rgb_size=56, depth_size=64, views=12, seed=7)
    first = feed.reset()
    second, _, _ = feed.step((0.6, 1.0))
    return [first, second]


def _compare_aux(taux, jaux):
    for name in jaux._fields:
        if name == "base":
            pairs = [(f"base.{n}", getattr(taux.base, n), getattr(jaux.base, n))
                     for n in jaux.base._fields]
        else:
            pairs = [(name, getattr(taux, name), getattr(jaux, name))]
        for label, a, b in pairs:
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape, label
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(a.numpy(), b, err_msg=label)
            else:
                np.testing.assert_allclose(np32(a), np32(b), rtol=1e-4, atol=1e-4, err_msg=label)


def test_perceive_panorama_matches(setup):
    jcfg, tcfg, jp, tp = setup
    G = 96
    rng = np.random.default_rng(2)
    gt_xyz = rng.uniform(0, 8, (1, G, 3)).astype(np.float32)
    gt_xyz[..., 2] = rng.uniform(0, 2.5, (1, G))
    gt_label = rng.integers(1, 40, (1, G)).astype(np.int32)
    gt_valid = rng.uniform(size=(1, G)) > 0.1
    per = jax.jit(lambda p, s, rgb, d, pos, hd: jp3.perceive_panorama(
        p, jcfg, s, rgb, d, pos, hd, jnp.asarray(gt_xyz), jnp.asarray(gt_label),
        jnp.asarray(gt_valid)))
    js = jax.tree_util.tree_map(lambda x: x[None], jm.init_state(jcfg.fields, jnp.float32))
    ts = stack_states([tm.init_state(tcfg.fields, "cpu", torch.float32)])
    for obs in _panoramas():
        args = (obs.rgb[None], obs.depth[None], obs.position[None],
                np.float32([obs.heading]))
        jout = per(jp, js, *(jnp.asarray(a) for a in args))
        tout = tp3.perceive_panorama(tp, tcfg, ts, *(torch.from_numpy(np.asarray(a))
                                                     for a in args),
                                     torch.from_numpy(gt_xyz), torch.from_numpy(gt_label),
                                     torch.from_numpy(gt_valid))
        _compare(unstack_state(tout.state, 0),
                 jax.tree_util.tree_map(lambda x: x[0], jout.state))
        _compare_aux(tout.aux, jout.aux)
        np.testing.assert_allclose(np32(tout.cls_fts), np32(jout.cls_fts), rtol=1e-4, atol=1e-4)
        for a, b, tol in ((tout.heatmap_logits, jout.heatmap_logits, 1e-4),
                          (tout.depth_feats, jout.depth_feats, 3e-4)):
            ref = np32(b)
            np.testing.assert_allclose(np32(a), ref, rtol=0, atol=tol * np.abs(ref).max())
        js, ts = jout.state, tout.state
    assert tout.depth_feats.shape == (1, 12, 128)
    assert int(ts.inst_valid.sum()) > 0 and int(ts.zone_valid.sum()) > 0
    assert not bool(ts.patch_valid.all())


def test_perceive_panorama_without_gt_or_waypoints(setup):
    """No gt point cloud (one invalid point stands in) and no waypoint
    branch: the state and the aux still agree."""
    jcfg, tcfg, jp, tp = setup
    obs = _panoramas()[1]
    args = (obs.rgb[None], obs.depth[None], obs.position[None], np.float32([obs.heading]))
    js = jax.tree_util.tree_map(lambda x: x[None], jm.init_state(jcfg.fields, jnp.float32))
    jout = jax.jit(lambda p, s, *a: jp3.perceive_panorama(p, jcfg, s, *a, with_waypoints=False))(
        jp, js, *(jnp.asarray(a) for a in args))
    tout = tp3.perceive_panorama(tp, tcfg, stack_states([tm.init_state(tcfg.fields, "cpu",
                                                                       torch.float32)]),
                                 *(torch.from_numpy(np.asarray(a)) for a in args),
                                 with_waypoints=False)
    assert tout.heatmap_logits is None and tout.depth_feats is None
    _compare(unstack_state(tout.state, 0),
             jax.tree_util.tree_map(lambda x: x[0], jout.state))
    _compare_aux(tout.aux, jout.aux)
    # the stand-in point's label 0 for every active segment, -1 elsewhere
    assert (tout.aux.seg_gt_id <= 0).all() and (tout.aux.seg_gt_id == 0).any()


def test_counter_clockwise_restore_undoes_the_reorder():
    x = np.arange(2 * 12 * 3).reshape(2, 12, 3)
    t = tp3.counter_clockwise_restore(tp3.clockwise_reorder(torch.from_numpy(x)))
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_array_equal(
        tp3.counter_clockwise_restore(torch.from_numpy(x)).numpy(),
        np.asarray(jp3.counter_clockwise_restore(jnp.asarray(x))))


def test_heatmap_candidates_and_sampled_waypoints_match(setup):
    jcfg, tcfg, jp, tp = setup
    depth12 = np.stack([o.depth for o in _panoramas()])        # [2, 12, 64, 64]
    jh = jax.jit(lambda p, d: jp3.waypoint_heatmap(p, jcfg, d))(jp, jnp.asarray(depth12))
    th = tp3.waypoint_heatmap(tp, tcfg, torch.from_numpy(depth12))
    ref = np32(jh)
    np.testing.assert_allclose(np32(th), ref, rtol=0, atol=1e-4 * np.abs(ref).max())

    # candidates of the same map, so the NMS rounds are the same
    jc = jp3.candidates_from_heatmap(jcfg, jnp.asarray(ref))
    tc = tp3.candidates_from_heatmap(tcfg, torch.from_numpy(ref))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.img_idxes.numpy(), np.asarray(jc.img_idxes))
    np.testing.assert_array_equal(np32(tc.distances), np32(jc.distances))
    np.testing.assert_allclose(np32(tc.angles_ccw), np32(jc.angles_ccw), rtol=0, atol=5e-7)
    assert tc.mask.any(1).all()

    # the walk driver's bins of the candidates' angles
    angles = [np.asarray(jc.angles_ccw[b])[np.asarray(jc.mask[b])] for b in range(2)]
    bins = [np.round((2 * np.pi - a) / (2 * np.pi) * 120).astype(np.int64) % 120
            for a in angles]
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    ja, jd = jp3.sample_waypoints_train(ref, bins, jr)
    ta, td = tp3.sample_waypoints_train(np32(th), bins, tr)
    assert ta == ja and td == jd
    assert jr.integers(0, 2 ** 31) == tr.integers(0, 2 ** 31)


def test_walk_candidates_fall_back_to_a_forward_fan(setup, monkeypatch):
    """A heatmap without candidates: the reference's forward fan (0 and
    +-pi/2 at 0.5 m), and no augmentation draw from the walk's generator."""
    from dynam3d_torch.runtime import pretrain_loop as tloop

    jcfg, tcfg, jp, tp = setup
    heat = torch.zeros(1, 120, 12)
    empty = tp3.candidates_from_heatmap(tcfg, heat)._replace(
        mask=torch.zeros(1, tcfg.waypoint.max_candidates, dtype=torch.bool))
    monkeypatch.setattr(tloop, "candidates_from_heatmap", lambda cfg, h: empty)
    walk = tloop.WalkDriver(None, {}, seed=3)
    angles, dists = walk._candidates(tcfg, heat)
    np.testing.assert_array_equal(angles, [0.0, np.pi / 2, -np.pi / 2])
    np.testing.assert_array_equal(dists, [0.5, 0.5, 0.5])
    assert walk.rng.integers(0, 2 ** 31) == np.random.default_rng(3).integers(0, 2 ** 31)
