"""Port parity of the YOLOv8-seg (FastSAM) segmenter,
``dynam3d_torch.models.encoders.yolov8_seg``, against the JAX package on
converted weights at width 0.125, depth (1,1,1,1).

Tolerances: ``forward``'s outputs within 1e-4 of each output's scale (the
same float32 convolutions summed in another order); the resize within 1e-6
(the same weight matrices contracted in another order); NMS indices and
validity, the id map and ``segment_views`` ids exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynam3d_tpu.config import SegmenterConfig as JSegCfg
from dynam3d_tpu.models.encoders import yolov8_seg as J
from dynam3d_torch.config import SegmenterConfig as TSegCfg
from dynam3d_torch.convert import conv_params_from_jax
from dynam3d_torch.models.encoders import yolov8_seg as T
from tests.torch_parity import np32

DEPTH = (1, 1, 1, 1)
# jitted once per shape: the reference's eager op-by-op dispatch is slow here
j_forward = jax.jit(J.forward, static_argnames=("depth_n",))
j_id_map = jax.jit(J.segment_id_map, static_argnums=(1, 2),
                   static_argnames=("conf", "iou_thr", "max_masks"))
j_views = jax.jit(J.segment_views, static_argnums=(1, 3, 4))
j_nms = jax.jit(J.nms_select, static_argnames=("conf", "iou_thr", "max_masks", "pre_topk"))


@pytest.fixture(scope="module")
def weights():
    jp = J.init_yolov8_params(jax.random.PRNGKey(0), width=0.125, depth_n=DEPTH)
    tp = conv_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _views(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("imgsz", [32, 64])
def test_forward_matches(weights, imgsz):
    jp, tp = weights
    x = np.random.default_rng(imgsz).uniform(size=(2, imgsz, imgsz, 3)).astype(np.float32)
    jo = j_forward(jp, jnp.asarray(x), depth_n=DEPTH)
    to = T.forward(tp, torch.from_numpy(x), depth_n=DEPTH)
    for name in T.SegOutput._fields:
        ref, got = np.asarray(getattr(jo, name)), np32(getattr(to, name))
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def test_init_params_mirror_the_reference_tree(weights):
    jp, tp = weights
    mine = T.init_yolov8_params(torch.Generator().manual_seed(0), width=0.125, depth_n=DEPTH,
                                device="cpu")
    shapes = [tuple(t.shape) for t in jax.tree_util.tree_leaves(tp)]
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(mine)] == shapes
    assert T.channels(1.25) == J.channels(1.25) == [80, 160, 320, 640, 640]
    assert T.channels(0.125) == J.channels(0.125)


def _nms_pair(boxes, scores, **kw):
    ji, jv = j_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    ti, tv = T.nms_select(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    return tv.numpy()


def test_nms_matches_on_forward_outputs(weights):
    jp, _ = weights
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jo = j_forward(jp, jnp.asarray(x), depth_n=DEPTH)
    for b in range(2):
        s = np.asarray(jo.scores[b])
        valid = _nms_pair(np.asarray(jo.boxes[b]), s, conf=float(np.median(s)), iou_thr=0.5,
                          max_masks=8)
        assert valid.sum() >= 2


def test_nms_breaks_ties_on_the_lower_index():
    """Saturated scores tie: the greedy order, and so which of two
    overlapping boxes survives, follows the candidate index."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (40, 2)).astype(np.float32)], 1)
    boxes[20:] = boxes[:20] + 0.5                        # near-duplicates of the first 20
    scores = np.ones(40, np.float32)
    scores[::3] = 0.75
    scores[1::7] = 0.3                                   # below conf
    valid = _nms_pair(boxes, scores, conf=0.4, iou_thr=0.6, max_masks=16, pre_topk=32)
    assert valid.sum() >= 4
    # every score equal: the reference's order is the index order
    _nms_pair(boxes, np.ones(40, np.float32), conf=0.4, iou_thr=0.6, max_masks=64)


def test_segment_id_map_contract_matches():
    """The crafted two-box output of tests/test_yolov8_seg.py."""
    Hp = Wp = 16
    protos = np.zeros((1, Hp, Wp, 2), np.float32)
    protos[0, :, :8, 0] = 8.0
    protos[0, :, 8:, 1] = 8.0
    boxes = np.zeros((1, 4, 4), np.float32)
    boxes[0, 0] = [0, 0, 32, 64]
    boxes[0, 1] = [32, 0, 64, 64]
    scores = np.zeros((1, 4), np.float32)
    scores[0, :2] = [0.9, 0.8]
    coeffs = np.zeros((1, 4, 2), np.float32)
    coeffs[0, 0, 0] = 1.0
    coeffs[0, 1, 1] = 1.0
    arrs = (boxes, scores, coeffs, protos)
    kw = dict(conf=0.4, iou_thr=0.8, max_masks=4)
    ref = np.asarray(j_id_map(J.SegOutput(*map(jnp.asarray, arrs)), (64, 64), (4, 4),
                                      **kw))
    got = T.segment_id_map(T.SegOutput(*map(torch.from_numpy, arrs)), (64, 64), (4, 4), **kw)
    np.testing.assert_array_equal(got.numpy(), ref)
    ids = got.numpy().reshape(4, 4)
    assert len(np.unique(ids)) == 2 and (ids[:, :2] == ids[0, 0]).all()


def test_segment_id_map_matches_on_forward_outputs(weights):
    jp, tp = weights
    x = np.random.default_rng(1).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    jo = j_forward(jp, jnp.asarray(x), depth_n=DEPTH)
    to = T.SegOutput(*(torch.from_numpy(np.asarray(a)) for a in jo))   # the same outputs
    for conf in (0.0, float(np.median(np.asarray(jo.scores)))):
        ref = np.asarray(j_id_map(jo, (64, 64), (8, 8), conf=conf, max_masks=8))
        got = T.segment_id_map(to, (64, 64), (8, 8), conf=conf, max_masks=8)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert (ref.max(axis=1) >= 1).all()


@pytest.mark.parametrize("size", [48, 96, 64])
def test_resize_matches_jax_image_resize(size):
    x = _views(2, size, size).astype(np.float32) / 255.0
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 64, 64, 3), method="bilinear"))
    got = T.resize_bilinear(torch.from_numpy(x), 64, 64).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [48, 96])
def test_segment_views_ids_identical(weights, size):
    """48² views are resized up to imgsz 64, 96² views down (antialiased)."""
    jp, tp = weights
    jseg = JSegCfg(provider="yolov8", imgsz=64, width_mult=0.125, depth_mult=0.2,
                   num_protos=32, max_masks=8, conf=0.45)
    assert jseg.depth_layers() == DEPTH
    tseg = TSegCfg(**dataclasses.asdict(jseg))
    assert tseg.depth_layers() == DEPTH
    rgb = _views(3, size, 10 + size)
    ref = np.asarray(j_views(jp, jseg, jnp.asarray(rgb), (8, 8), 6))
    got = T.segment_views(tp, tseg, torch.from_numpy(rgb), (8, 8), 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.shape == (3, 64) and (ref.max(axis=1) >= 1).all()
