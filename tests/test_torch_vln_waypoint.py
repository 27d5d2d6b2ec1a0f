"""The waypoint predictor through the port and the JAX package on the same
converted weights (tiny slice config: depth encoder at ``input_size`` 64,
one TRM layer of width 64): ``heatmap_nms``, ``encode_depth``,
``predict_heatmap``, ``extract_candidates``, ``clockwise_reorder`` and the
trainer's whole panorama -> candidates path.

NMS picks exactly (the same argmax rounds on the same map); depth features
within 1e-5 of their scale (float32 convolutions summed in another order);
heatmap logits within 1e-5 of their scale on given features, 1e-4 through
the depth encoder; candidates identical, angles within an f32
ulp (XLA folds ``2 pi / 120`` into one constant)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import DepthEncoderConfig as JDepthCfg
from dynam3d_tpu.models import policy_3dff as jp3dff
from dynam3d_tpu.models.encoders import depth_resnet as jdepth
from dynam3d_tpu.models.waypoint import trm as jtrm
from dynam3d_tpu.ops.nms import heatmap_nms as jnms
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.config import DepthEncoderConfig as TDepthCfg
from dynam3d_torch.convert import conv_params_from_jax
from dynam3d_torch.models import policy_3dff as tp3dff
from dynam3d_torch.models.encoders import depth_resnet as tdepth
from dynam3d_torch.models.waypoint import trm as ttrm
from dynam3d_torch.ops.nms import heatmap_nms as tnms
from tests.torch_parity import np32, port_config, slice_config, to_torch


@pytest.fixture(scope="module")
def cfgs():
    jcfg = slice_config()
    return jcfg, port_config(jcfg)


@pytest.mark.parametrize("case", ["random", "ties", "plateau", "wrap"])
def test_heatmap_nms_matches(case):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.1, 1.0, (3, 122, 12)).astype(np.float32)
    if case == "ties":
        x = np.round(x * 4) / 4          # many equal maxima: first index wins
    if case == "plateau":
        x = np.full_like(x, 0.5)         # every value ties: each round's first survivor
    if case == "wrap":
        x[:, 5, 0] = 2.0                 # a peak at the first column: circular window
        x[:, 9, 11] = 1.9
    ref = np.asarray(jnms(jnp.asarray(x), 5, (7.0, 5.0)))
    got = tnms(torch.from_numpy(x), 5, (7.0, 5.0)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ((got > 0).sum(axis=(1, 2)) >= 1).all()


@pytest.mark.parametrize("size", [64, 50])
def test_encode_depth_matches(size):
    """``input_size`` 64, and 50, whose odd 25 x 25 map takes the pool's
    "SAME" padding on both sides."""
    cfg = JDepthCfg(input_size=size, output_size=32, base_planes=8, ngroups=4)
    jp = jdepth.init_depth_params(jax.random.PRNGKey(size), cfg)
    d = np.random.default_rng(size).uniform(0, 1, (2, size, size, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jdepth.encode_depth(p, cfg, x))(jp, d))
    tcfg = TDepthCfg(input_size=size, output_size=32, base_planes=8, ngroups=4)
    tp = conv_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert tp["stem_conv"]["w"].shape == (8, 1, 7, 7)         # OIHW
    got = tdepth.encode_depth(tp, tcfg, torch.from_numpy(d)).numpy()
    assert got.shape == ref.shape == (2, tdepth.feature_dim(tcfg))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_init_depth_params_shapes_match(cfgs):
    jcfg, tcfg = cfgs
    jp = jax.tree_util.tree_map(np.asarray, jdepth.init_depth_params(jax.random.PRNGKey(0),
                                                                     jcfg.depth))
    tp = tdepth.init_depth_params(torch.Generator().manual_seed(0), tcfg.depth, device="cpu")
    conv = conv_params_from_jax(jp, device="cpu")
    shapes = lambda t: [tuple(x.shape) for x in jax.tree_util.tree_leaves(t)]  # noqa: E731
    assert shapes(tp) == shapes(conv)
    w = tp["stages"][1][0]["conv2"]["w"]
    np.testing.assert_allclose(float(w.std()), (2.0 / (9 * 16)) ** 0.5, rtol=0.1)


def test_neighbor_mask_and_clockwise_reorder_match():
    for n, k in ((12, 1), (12, 2), (8, 0)):
        np.testing.assert_array_equal(ttrm.neighbor_attention_mask(n, k),
                                      jtrm.neighbor_attention_mask(n, k))
    x = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    np.testing.assert_array_equal(tp3dff.clockwise_reorder(torch.from_numpy(x)).numpy(),
                                  np.asarray(jp3dff.clockwise_reorder(jnp.asarray(x))))


@pytest.fixture(scope="module")
def predictor(cfgs):
    jcfg, tcfg = cfgs
    jde = jdepth.init_depth_params(jax.random.PRNGKey(4), jcfg.depth)
    jwp = jtrm.init_waypoint_params(jax.random.PRNGKey(3), jcfg.waypoint, depth_feat_dim=128)
    tde = conv_params_from_jax(jax.tree_util.tree_map(np.asarray, jde), device="cpu")
    return jde, jwp, tde, to_torch(jwp)


def test_predict_heatmap_and_candidates_match(cfgs, predictor):
    jcfg, tcfg = cfgs
    _, jwp, _, twp = predictor
    feats = np.random.default_rng(5).standard_normal((24, 128)).astype(np.float32)
    jh = np.array(jtrm.predict_heatmap(jwp, jcfg.waypoint, jnp.asarray(feats)))
    th = ttrm.predict_heatmap(twp, tcfg.waypoint, torch.from_numpy(feats))
    assert th.shape == (2, 120, 12)
    np.testing.assert_allclose(np32(th), jh, rtol=0, atol=1e-5 * np.abs(jh).max())
    # candidates from the same logits
    jc = jtrm.extract_candidates(jcfg.waypoint, jnp.asarray(jh))
    tc = ttrm.extract_candidates(tcfg.waypoint, torch.from_numpy(jh))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.img_idxes.numpy(), np.asarray(jc.img_idxes))
    np.testing.assert_array_equal(tc.distances.numpy(), np.asarray(jc.distances))
    np.testing.assert_allclose(tc.angles_ccw.numpy(), np.asarray(jc.angles_ccw), rtol=1e-6)


def test_panorama_to_candidates_matches(cfgs, predictor):
    """The trainer's path: 12 normalized depth views (counter-clockwise) ->
    clockwise -> metric / 10 -> depth features -> heatmap -> candidates."""
    from dynam3d_torch.runtime.vln_loop import VLNTrainer

    jcfg, tcfg = cfgs
    jde, jwp, tde, twp = predictor
    obs = JFeed(rgb_size=56, depth_size=64, views=12, seed=3).reset()
    dep12 = jnp.asarray(obs.depth[None])

    def jpath(dp, wp, dep):
        d = jp3dff.clockwise_reorder(dep)
        d = jdepth.preprocess_depth(d.reshape(12, *d.shape[2:])[..., None], (0.0, 10.0)) / 10.0
        hm = jtrm.predict_heatmap(wp, jcfg.waypoint, jdepth.encode_depth(dp, jcfg.depth, d))
        return hm, jtrm.extract_candidates(jcfg.waypoint, hm)

    jh, jc = jax.jit(jpath)(jde, jwp, dep12)
    tr = VLNTrainer.__new__(VLNTrainer)
    tr.cfg, tr.depth_enc_params, tr.waypoint_params = tcfg, tde, twp
    th = tr.waypoint_heatmap(torch.from_numpy(obs.depth[None]))
    np.testing.assert_allclose(np32(th), np.asarray(jh), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jh)).max())
    tc = tr._waypoint_candidates(torch.from_numpy(obs.depth[None]))
    assert bool(tc.mask.any())
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.distances.numpy(), np.asarray(jc.distances))
    np.testing.assert_allclose(tc.angles_ccw.numpy(), np.asarray(jc.angles_ccw), rtol=1e-6)
