"""Port parity of kernels E, F and G (the plain versions of
``int4_matvec2d``, ``int4_mlp`` and ``int4_mlp_block``) and of their
dispatchers, against the JAX package at D=256, I=512, dblk=nblk=128:

* each plain version against the TPU kernel run in interpret mode
  (``_pallas_int4_matmul2d`` / ``_pallas_int4_mlp`` / ``_pallas_int4_mlp_block``)
  at 1, 8, 12 and 16 rows;
* the ``int4_mlp`` / ``int4_mlp_block`` chains taken by packs the kernels do
  not take (column padding) against the JAX wrappers, and the eligible
  packs' dispatch to the plain versions;
* ``int4_matmul`` under ``DYNAM3D_INT4_GRID2D``;
* a block-major pack converted by ``params_from_jax``.

Tolerances, with the largest error measured on the CPU: E vs the
interpret-mode kernel 1e-5 absolute on outputs of magnitude ~1 (the same
exact integer x bf16 products summed in f32 in another order; measured
1.2e-7).  F and G vs the interpret-mode kernels 1e-3 absolute on outputs of
magnitude ~1: the gate and up sums differ in the last f32 bits, which can
move the bf16 rounding of an element of h by one step (measured 3.6e-7 and
4.8e-7, no step moved).  The chains vs the JAX CPU wrappers, which multiply
by dequantized weights rounded to bf16: 3e-2 of the output's scale
(measured 3.9e-3)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.ops import pallas_int4 as P
from dynam3d_torch.ops import int4 as T
from tests.torch_parity import np32, to_torch

D, I, BLK = 256, 512, 128
ROWS = [1, 8, 12, 16]


def _w(shape, seed):
    return np.random.default_rng(seed).normal(scale=0.05, size=shape).astype(np.float32)


def _pair(shape, seed, blk=BLK):
    w = _w(shape, seed)
    return (P.pack_int4(jnp.asarray(w), dblk=blk, nblk=blk),
            T.pack_int4(torch.from_numpy(w), dblk=blk, nblk=blk))


def _x(rows, d, seed):
    x = np.random.default_rng(100 + seed).normal(size=(rows, d)).astype(np.float32)
    xb = np32(jnp.asarray(x, jnp.bfloat16))          # bf16 values, as the kernels see them
    return xb, jnp.pad(jnp.asarray(xb, jnp.bfloat16), ((0, 16 - rows), (0, 0)))


@pytest.mark.parametrize("rows", ROWS)
def test_matvec2d_plain_matches_pallas_interpret(rows):
    jw, tw = _pair((D, 3 * D), rows)
    x, xp = _x(rows, D, rows)
    ref = np.asarray(P._pallas_int4_matmul2d(xp, jw, interpret=True))[:rows, : 3 * D]
    got = np32(T.int4_matvec2d(torch.from_numpy(x), tw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # kernel A's arithmetic on the same inputs: the same sums in another order
    np.testing.assert_allclose(got, np32(T.int4_matvec(torch.from_numpy(x), tw)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("rows", ROWS)
def test_mlp_plain_matches_pallas_interpret(rows):
    (jgu, tgu), (jdn, tdn) = _pair((D, 2 * I), 10 + rows), _pair((I, D), 20 + rows)
    x, xp = _x(rows, D, rows)
    ref = np.asarray(P._pallas_int4_mlp(xp, jgu, jdn, interpret=True))[:rows, :D]
    got = np32(T.int4_mlp_plain(torch.from_numpy(x), tgu, tdn))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("rows", ROWS)
def test_mlp_block_plain_matches_pallas_interpret(rows):
    (jgu, tgu), (jdn, tdn) = _pair((D, 2 * I), 30 + rows), _pair((I, D), 40 + rows)
    x, xp = _x(rows, D, rows)
    ln = (1.0 + 0.2 * np.random.default_rng(rows).normal(size=D)).astype(np.float32)
    ref = np.asarray(P._pallas_int4_mlp_block(xp, jnp.asarray(ln)[None], jgu, jdn, 1e-5,
                                              interpret=True))[:rows]
    got = np32(T.int4_mlp_block_plain(torch.from_numpy(x), torch.from_numpy(ln), tgu, tdn,
                                      1e-5))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_eligible_packs_dispatch_to_the_plain_versions():
    (jgu, tgu), (jdn, tdn) = _pair((D, 2 * I), 50), _pair((I, D), 51)
    x, _ = _x(3, D, 5)
    xt = torch.from_numpy(x).to(torch.bfloat16).view(3, 1, D)
    ln = torch.ones(D)
    got = T.int4_mlp(xt, tgu, tdn, out_dtype=torch.float32)
    assert got.shape == (3, 1, D)
    np.testing.assert_array_equal(np32(got).reshape(3, D),
                                  np32(T.int4_mlp_plain(xt.view(3, D), tgu, tdn)))
    got = T.int4_mlp_block(xt, ln, tgu, tdn, 1e-5, out_dtype=torch.float32)
    np.testing.assert_array_equal(np32(got).reshape(3, D),
                                  np32(T.int4_mlp_block_plain(xt.view(3, D), ln, tgu, tdn,
                                                              1e-5)))


def test_padded_packs_take_the_reference_chains():
    """D=200, I=300: gate_up's packed columns carry padding, so neither
    kernel takes the packs; both dispatchers run the reference's chain."""
    d, i = 200, 300
    (jgu, tgu), (jdn, tdn) = _pair((d, 2 * i), 60), _pair((i, d), 61)
    assert not T._mlp_eligible(4, tgu, tdn)
    x, _ = _x(4, d, 6)
    ref = np.asarray(P.int4_mlp(jnp.asarray(x, jnp.bfloat16), jgu, jdn, out_dtype=jnp.float32))
    got = np32(T.int4_mlp(torch.from_numpy(x).to(torch.bfloat16), tgu, tdn,
                          out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())
    ln = (1.0 + 0.2 * np.random.default_rng(7).normal(size=d)).astype(np.float32)
    ref = np.asarray(P.int4_mlp_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ln), jgu, jdn,
                                      1e-5, out_dtype=jnp.float32))
    got = np32(T.int4_mlp_block(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(ln),
                                tgu, tdn, 1e-5, out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_eligible_block_matches_the_reference_wrapper():
    """The eligible MLP block (kernel G's arithmetic) against the JAX
    wrapper, which on the CPU runs its rmsnorm -> int4_mlp chain."""
    (jgu, tgu), (jdn, tdn) = _pair((D, 2 * I), 70), _pair((I, D), 71)
    x, _ = _x(5, D, 7)
    ln = np.ones(D, np.float32)
    ref = np.asarray(P.int4_mlp_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ln), jgu, jdn,
                                      1e-5, out_dtype=jnp.float32))
    got = np32(T.int4_mlp_block(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(ln),
                                tgu, tdn, 1e-5, out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_grid2d_flag_routes_int4_matmul_to_kernel_e(monkeypatch):
    _, tw = _pair((D, 3 * D), 80)
    x = torch.from_numpy(_x(2, D, 8)[0])
    calls = []
    real = T.int4_matvec2d_plain
    monkeypatch.setattr(T, "int4_matvec2d_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    T.int4_matmul(x, tw, out_dtype=torch.float32)
    assert not calls
    monkeypatch.setenv("DYNAM3D_INT4_GRID2D", "1")
    got = T.int4_matmul(x.view(2, 1, D), tw, out_dtype=torch.float32)
    assert calls == [1] and got.shape == (2, 1, 3 * D)
    np.testing.assert_array_equal(np32(got).reshape(2, 3 * D), np32(real(x, tw)))


def test_block_major_pack_converts_to_the_flat_bytes():
    w = _w((D, 2 * I), 90)
    flat = P.pack_int4(jnp.asarray(w), dblk=BLK, nblk=BLK)
    blk = P.pack_int4(jnp.asarray(w), dblk=BLK, nblk=BLK, blocked=True)
    assert np.asarray(blk.q4).ndim == 3
    tf, tb = to_torch({"w": flat})["w"], to_torch({"w": blk})["w"]
    np.testing.assert_array_equal(tb.q4.numpy(), np.asarray(flat.q4))
    np.testing.assert_array_equal(tb.q4.numpy(), tf.q4.numpy())
    np.testing.assert_array_equal(tb.s_lo.numpy(), tf.s_lo.numpy())
    assert (tb.dp, tb.n2, tb.dblk, tb.nblk) == (flat.dp, flat.n2, BLK, BLK)
