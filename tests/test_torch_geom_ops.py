"""Port parity of the geometry and non-kernel ops: projection, transformer
blocks, segment reductions, k-NN and the depth-plane segmenter, each held
against the JAX function on the same numpy inputs.

Tolerances: float32 elementwise geometry 1e-5 (relative, values in metres
up to ~10); float32 matmul chains 1e-4 (summation order differs between
XLA and PyTorch); indices, masks and integer outputs exactly."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import FieldsConfig
from dynam3d_tpu.geom import projection as jproj
from dynam3d_tpu.models.segmenter import depth_plane_segments as j_segments
from dynam3d_tpu.ops import knn as jknn
from dynam3d_tpu.ops import segment as jseg
from dynam3d_tpu.ops import transformer as jtr
import jax

from dynam3d_torch.geom import projection as tproj
from dynam3d_torch.models.segmenter import depth_plane_segments as t_segments
from dynam3d_torch.ops import knn as tknn
from dynam3d_torch.ops import segment as tseg
from dynam3d_torch.ops import transformer as ttr
from tests.torch_parity import np32, to_torch


@pytest.mark.parametrize("hw", [(4, 4), (24, 24)])
def test_unproject_and_patch_info(hw):
    H, W = hw
    rng = np.random.default_rng(H)
    depth = rng.uniform(0.3, 9.5, (2, H * W)).astype(np.float32)
    heading = rng.uniform(-3, 3, (2,)).astype(np.float32)
    j = jproj.unproject_depth_habitat(jnp.asarray(depth), jnp.asarray(heading), height=H, width=W)
    t = tproj.unproject_depth_habitat(torch.from_numpy(depth), torch.from_numpy(heading),
                                      height=H, width=W)
    for a, b in zip(j, t):
        np.testing.assert_allclose(np32(b), np32(a), rtol=1e-5, atol=1e-5)
    j = jproj.patch_3d_info(jnp.asarray(depth), height=H, width=W)
    t = tproj.patch_3d_info(torch.from_numpy(depth), height=H, width=W)
    for a, b in zip(j, t):
        np.testing.assert_allclose(np32(b), np32(a), rtol=1e-5, atol=1e-5)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np32(tproj.habitat_to_world(torch.from_numpy(pos))),
        np32(jproj.habitat_to_world(jnp.asarray(pos))))


def test_frustum_mask_matches_exactly():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    pts[:20] = -10000.0                           # tombstones
    dmap = rng.uniform(0.5, 6, (32, 32)).astype(np.float32)
    cam = np.float32([0.3, -0.2, 1.25])
    for heading in (0.0, 1.1, -2.5):
        j = jproj.frustum_mask_habitat(jnp.asarray(pts), jnp.asarray(dmap), jnp.asarray(cam),
                                       jnp.float32(heading), height=32, width=32)
        t = tproj.frustum_mask_habitat(torch.from_numpy(pts), torch.from_numpy(dmap),
                                       torch.from_numpy(cam), torch.tensor(heading),
                                       height=32, width=32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_transformer_blocks():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    enc = jtr.init_encoder_stack(key, 64, 128, 2)
    mlp = jtr.init_mlp2(jax.random.PRNGKey(1), 7, 64, 64)
    enc_t, mlp_t = to_torch(enc), to_torch(mlp)
    x = rng.normal(size=(3, 10, 64)).astype(np.float32)
    kp = np.ones((3, 10), bool)
    kp[1, 6:] = False
    group = rng.integers(0, 3, 10)
    am = group[:, None] == group[None, :]
    j = jtr.encoder_stack(enc, jnp.asarray(x), 1, key_padding_mask=jnp.asarray(kp))
    t = ttr.encoder_stack(enc_t, torch.from_numpy(x), 1, key_padding_mask=torch.from_numpy(kp))
    np.testing.assert_allclose(np32(t), np32(j), rtol=1e-4, atol=1e-4)
    j = jtr.encoder_stack(enc, jnp.asarray(x[0]), 1, attn_mask=jnp.asarray(am))
    t = ttr.encoder_stack(enc_t, torch.from_numpy(x[0]), 1, attn_mask=torch.from_numpy(am))
    np.testing.assert_allclose(np32(t), np32(j), rtol=1e-4, atol=1e-4)
    e = rng.normal(size=(6, 7)).astype(np.float32)
    np.testing.assert_allclose(np32(ttr.mlp2(mlp_t, torch.from_numpy(e))),
                               np32(jtr.mlp2(mlp, jnp.asarray(e))), rtol=1e-4, atol=1e-4)
    ln = {"scale": rng.normal(size=64).astype(np.float32),
          "bias": rng.normal(size=64).astype(np.float32)}
    np.testing.assert_allclose(
        np32(ttr.layer_norm({k: torch.from_numpy(v) for k, v in ln.items()}, torch.from_numpy(x))),
        np32(jtr.layer_norm({k: jnp.asarray(v) for k, v in ln.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_segment_ops():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(50, 3)).astype(np.float32)
    ids = rng.integers(0, 6, 50)
    jm, jc = jseg.segment_mean(jnp.asarray(vals), jnp.asarray(ids), 8)
    tm, tc = tseg.segment_mean(torch.from_numpy(vals), torch.from_numpy(ids), 8)
    np.testing.assert_allclose(np32(tm), np32(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np32(tc), np32(jc))
    for frac in (0.2, 0.9, 1.0):
        valid = rng.uniform(size=40) < frac
        for k in (3, 10):
            np.testing.assert_array_equal(
                tseg.first_free_slots(torch.from_numpy(valid), k).numpy(),
                np.asarray(jseg.first_free_slots(jnp.asarray(valid), k)))
            assert bool(tseg.free_slot_ok(torch.from_numpy(valid), k)) == bool(
                jseg.free_slot_ok(jnp.asarray(valid), k))


def test_knn_brute_ties_and_dead_slots():
    rng = np.random.default_rng(2)
    pts = rng.integers(-3, 4, (60, 3)).astype(np.float32)   # many exact ties
    valid = rng.uniform(size=60) < 0.7
    q = rng.integers(-3, 4, (9, 3)).astype(np.float32)
    jd, ji = jknn.knn_brute(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(valid), 4)
    td, ti = tknn.knn_brute(torch.from_numpy(q), torch.from_numpy(pts),
                            torch.from_numpy(valid), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)
    dead = np.zeros(60, bool)
    dead[5] = True
    jd, ji = jknn.knn_brute(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(dead), 3)
    td, ti = tknn.knn_brute(torch.from_numpy(q), torch.from_numpy(pts),
                            torch.from_numpy(dead), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (td[:, 1:] >= 1e10).all()
    for clamp in (False, True):
        jr = jknn.radius_mask_fill(jd, ji, 1.5, clamp_dist=clamp)
        tr = tknn.radius_mask_fill(td, ti, 1.5, clamp_dist=clamp)
        np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_plane_segments_exact(seed):
    rng = np.random.default_rng(seed)
    d = np.repeat(rng.uniform(0.5, 8, (6, 1)), 24, axis=1)     # banded planes
    d = (d + rng.normal(scale=0.01, size=d.shape)).astype(np.float32)
    d = np.kron(d, np.ones((4, 1), np.float32))[:24].reshape(-1)
    for max_seg in (4, 64):
        j = j_segments(jnp.asarray(d), 24, 24, max_seg)
        t = t_segments(torch.from_numpy(d), 24, 24, max_seg)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    dd = rng.uniform(0.5, 8, (3, 16)).astype(np.float32)
    t = t_segments(torch.from_numpy(dd), 4, 4, 8)
    for i in range(3):
        np.testing.assert_array_equal(t[i].numpy(), np.asarray(j_segments(jnp.asarray(dd[i]), 4, 4, 8)))


def test_cell_center_matches():
    from dynam3d_tpu.models.memory3d.state import cell_center as j_cell
    from dynam3d_torch.config import FieldsConfig as TFields
    from dynam3d_torch.models.memory3d.state import cell_center as t_cell

    p = np.random.default_rng(4).uniform(-9, 9, (30, 3)).astype(np.float32)
    np.testing.assert_array_equal(np32(t_cell(torch.from_numpy(p), TFields())),
                                  np32(j_cell(jnp.asarray(p), FieldsConfig())))
