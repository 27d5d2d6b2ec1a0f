"""Port parity of the renderer (``models/render/nerf.py``) and of kernel
C's contract (``ops/pallas_mlp.py::fused_nerf_mlp``).

* ``nerf_mlp_plain`` vs the TPU kernel in interpret mode: within one bf16
  step (both round the weights to bf16; sums in another order).
* The chain behind ``nerf_mlp`` on the CPU vs JAX's: outputs within 1e-5;
  gradients (``torch.autograd`` vs ``jax.vjp``) within one bf16 step of
  each tensor's scale.  The backward pass rounds every cotangent to bf16
  after a float32 dot; summed in another order, a rounding now and then
  lands one bf16 step away and spreads along its row (measured: at most
  0.34% of the scale, ~0.1% in norm).
* ``render_view`` / ``render_view_posed`` on a 100-point cloud: identical
  importance samples (the stage-1 tie order); depth and positions within
  1e-5; features within 1e-4 plus one bf16 step (2**-8 relative), as the
  MLP's bf16 roundings can land one step apart in the same way."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import FieldsConfig
from dynam3d_tpu.models.memory3d import init_state
from dynam3d_tpu.models.render import nerf as jnerf
from dynam3d_tpu.ops.pallas_mlp import fused_nerf_mlp
from dynam3d_torch.convert import state_from_jax
from dynam3d_torch.models.render import nerf as tnerf
from dynam3d_torch.ops.nerf_mlp import nerf_mlp_plain
from tests.torch_parity import np32, port_config, to_torch

CFG = FieldsConfig(fts_dim=32, patch_capacity=256, view_height=4, view_width=4, n_samples=33,
                   n_importance=4, search_num=2, mlp_net_layers=4, mlp_net_width=32, far=10.0)


def _bf16_step(ref: np.ndarray) -> np.ndarray:
    """One bf16 rounding step (8 mantissa bits) at each value's magnitude."""
    return np.maximum(np.abs(ref), 1e-3) * 2.0 ** -7


def _mlp_weights():
    p = jnerf.init_render_params(jax.random.PRNGKey(0), CFG)["mlp"]
    return [p["enc_hidden"][0], p["enc_hidden"][1], p["enc_out"], p["dec_hidden"][0],
            p["dec_hidden"][1], p["dec_out"]]


def test_kernel_c_plain_matches_the_tpu_kernel():
    w = _mlp_weights()
    x = np.random.default_rng(0).normal(size=(37, 32)).astype(np.float32)
    jo, jd = fused_nerf_mlp(jnp.asarray(x), *w, tile=16, interpret=True)
    to, td = nerf_mlp_plain(torch.from_numpy(x), *(to_torch(a) for a in w))
    assert to.dtype == torch.bfloat16 and to.shape == (37, 32) and td.shape == (37,)
    for a, b in ((to, jo), (td, jd)):
        ref = np32(b)
        assert (np.abs(np32(a) - ref) <= _bf16_step(ref)).all()


def test_nerf_mlp_chain_and_gradients_match_reference():
    w = _mlp_weights()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(23, 32)).astype(np.float32)
    g_out = rng.normal(size=(23, 32)).astype(np.float32)
    g_den = rng.normal(size=(23,)).astype(np.float32)
    p = {"enc_hidden": w[:2], "enc_out": w[2], "dec_hidden": w[3:5], "dec_out": w[5]}

    def jf(x, p):
        return jnerf.nerf_mlp(p, x, CFG)

    (jo, jd), vjp = jax.vjp(jf, jnp.asarray(x), p)
    jgx, jgp = vjp((jnp.asarray(g_out, jnp.bfloat16), jnp.asarray(g_den, jnp.bfloat16)))

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = to_torch(p)
    leaves = [tp["enc_hidden"][0], tp["enc_hidden"][1], tp["enc_out"], tp["dec_hidden"][0],
              tp["dec_hidden"][1], tp["dec_out"]]
    for t in leaves:
        t.requires_grad_(True)
    to, td = tnerf.nerf_mlp(tp, tx, port_config_fields())
    grads = torch.autograd.grad((to, td), [tx, *leaves],
                                (torch.from_numpy(g_out).to(torch.bfloat16),
                                 torch.from_numpy(g_den).to(torch.bfloat16)))
    np.testing.assert_allclose(np32(to), np32(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np32(td), np32(jd), rtol=1e-5, atol=1e-5)
    jl = [jgx, jgp["enc_hidden"][0], jgp["enc_hidden"][1], jgp["enc_out"],
          jgp["dec_hidden"][0], jgp["dec_hidden"][1], jgp["dec_out"]]
    for a, b in zip(grads, jl):
        ref = np32(b)
        assert np.abs(np32(a) - ref).max() <= 2.0 ** -7 * np.abs(ref).max()
        assert np.linalg.norm(np32(a) - ref) <= 5e-3 * np.linalg.norm(ref)


def port_config_fields():
    from dynam3d_tpu.config import Dynam3DConfig

    return port_config(Dynam3DConfig(fields=CFG)).fields


def _state_with_cloud(n=100, seed=0):
    state = init_state(CFG)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 1.0
    fts = rng.normal(size=(n, CFG.fts_dim)).astype(np.float32)
    return state._replace(
        patch_pos=state.patch_pos.at[:n].set(jnp.asarray(pos)),
        patch_fts=state.patch_fts.at[:n].set(jnp.asarray(fts, state.patch_fts.dtype)),
        patch_dir=state.patch_dir.at[:n].set(jnp.asarray(rng.uniform(-3, 3, n), jnp.float32)),
        patch_scale=state.patch_scale.at[:n].set(0.05),
        patch_valid=state.patch_valid.at[:n].set(True),
    )


def _spy(monkeypatch, module, seen):
    real = module.raw2feature

    def spy(feat, dens, rel_dist, topk_inds):
        seen.append(np.asarray(topk_inds.detach() if hasattr(topk_inds, "detach") else topk_inds))
        return real(feat, dens, rel_dist, topk_inds)

    monkeypatch.setattr(module, "raw2feature", spy)


@pytest.mark.parametrize("posed", [False, True])
def test_render_matches_reference(monkeypatch, posed):
    _check_render_against_reference(monkeypatch, posed)


def test_render_unsorted_banded_knn_matches_reference(monkeypatch):
    """``DYNAM3D_DISABLE_MORTON_KNN``: the banded scan reads the table in
    slot order, in both packages, and renders the same view."""
    from dynam3d_tpu import flags as jflags

    monkeypatch.setattr(jflags, "DISABLE_MORTON_KNN", True)
    monkeypatch.setenv("DYNAM3D_DISABLE_MORTON_KNN", "1")
    sorts = []
    real_perm = tnerf.morton_perm
    monkeypatch.setattr(tnerf, "morton_perm", lambda *a: sorts.append(1) or real_perm(*a))
    _check_render_against_reference(monkeypatch, posed=False)
    assert not sorts


def _check_render_against_reference(monkeypatch, posed):
    jp = jnerf.init_render_params(jax.random.PRNGKey(3), CFG)
    tp = to_torch(jp)
    js = _state_with_cloud()
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    tcfg = port_config_fields()
    jseen, tseen = [], []
    _spy(monkeypatch, jnerf, jseen)
    _spy(monkeypatch, tnerf, tseen)
    if posed:
        k = np.float32([[2.0, 0, 2.0], [0, 2.0, 2.0], [0, 0, 1]])
        hd = 0.4
        rot = np.stack([[math.cos(hd), math.sin(hd), 0.0], [0.0, 0.0, -1.0],
                        [-math.sin(hd), math.cos(hd), 0.0]], axis=1).astype(np.float32)
        trans = np.float32([0.3, -0.2, 1.25])
        jo = jnerf.render_view_posed(jp, CFG, js, jnp.asarray(k), jnp.asarray(rot),
                                     jnp.asarray(trans))
        to = tnerf.render_view_posed(tp, tcfg, ts, torch.from_numpy(k), torch.from_numpy(rot),
                                     torch.from_numpy(trans))
    else:
        pos, hd = np.float32([0.2, -0.5, 0.3]), np.float32(0.3)
        jo = jnerf.render_view(jp, CFG, js, jnp.asarray(pos), jnp.asarray(hd))
        to = tnerf.render_view(tp, tcfg, ts, torch.from_numpy(pos), torch.tensor(hd))
    np.testing.assert_array_equal(tseen[0], jseen[0])
    assert len(np.unique(jseen[0][:, 0])) > 1
    np.testing.assert_allclose(np32(to.features), np32(jo.features), rtol=2.0 ** -8, atol=1e-4)
    np.testing.assert_allclose(np32(to.positions), np32(jo.positions), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np32(to.depth), np32(jo.depth), rtol=1e-5, atol=1e-5)
    assert np.linalg.norm(np32(to.features).reshape(16, -1), axis=-1).max() > 0.5


def test_render_stage1_flat_knn_matches_banded(monkeypatch):
    """The flag configuration (flat k-NN, kernel D's path on the card)
    renders the same view as the default banded scan: stage 1 reads only
    distances within the radius."""
    tp = to_torch(jnerf.init_render_params(jax.random.PRNGKey(3), CFG))
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, _state_with_cloud()), device="cpu")
    tcfg = port_config_fields()
    args = (tp, tcfg, ts, torch.tensor([0.2, -0.5, 0.3]), torch.tensor(0.3))
    banded = tnerf.render_view(*args)
    monkeypatch.setenv("DYNAM3D_DISABLE_BANDED_KNN", "1")
    monkeypatch.setenv("DYNAM3D_ENABLE_PALLAS_KNN", "1")
    flat = tnerf.render_view(*args)
    for a, b in zip(flat, banded):
        np.testing.assert_allclose(np32(a), np32(b), rtol=1e-6, atol=1e-6)

