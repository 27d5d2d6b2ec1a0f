"""Port parity of the int4 packing and the int4 matvec's plain version
(kernel A's arithmetic), against the JAX package: ``pack_int4`` bytes and
scales bit-identical; the matvec against the Pallas kernel in interpret
mode and against the XLA dequantize oracle.

Tolerances: vs the interpret-mode kernel (same exact integer x bf16
products, f32 sums per group in another order) 1e-5 absolute on outputs of
magnitude ~1; vs the XLA oracle, which rounds the dequantized weight to
bf16 first, 2e-2 relative."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.ops import pallas_int4 as P
from dynam3d_torch.ops import int4 as T
from tests.torch_parity import np32


def _pair(d, n, dblk, nblk, seed=0, scale=0.02):
    w = np.random.default_rng(seed).normal(scale=scale, size=(d, n)).astype(np.float32)
    return P.pack_int4(jnp.asarray(w), dblk=dblk, nblk=nblk), \
        T.pack_int4(torch.from_numpy(w), dblk=dblk, nblk=nblk)


@pytest.mark.parametrize("d,n,dblk,nblk", [(200, 300, 64, 64), (128, 384, 64, 64),
                                          (96, 40, 1024, 512)])
def test_pack_int4_bit_identical(d, n, dblk, nblk):
    jw, tw = _pair(d, n, dblk, nblk)
    np.testing.assert_array_equal(tw.q4.numpy(), np.asarray(jw.q4))
    np.testing.assert_array_equal(tw.s_lo.numpy(), np.asarray(jw.s_lo))
    np.testing.assert_array_equal(tw.s_hi.numpy(), np.asarray(jw.s_hi))
    assert (tw.d, tw.n, tw.dp, tw.n2) == (jw.d, jw.n, jw.dp, jw.n2)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_matvec_plain_vs_pallas_interpret_and_oracle(rows):
    jw, tw = _pair(200, 300, 64, 64, seed=rows)
    x = np.random.default_rng(rows).normal(size=(rows, 200)).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 16 - rows), (0, jw.dp - 200)))
    ref_k = np.asarray(P._pallas_int4_matmul(xp, jw, interpret=True))[:rows, :300]
    ref_x = np.asarray(P._xla_int4_matmul(xp, jw))[:rows, :300]
    got = np32(T.int4_matvec(torch.from_numpy(x), tw))
    np.testing.assert_allclose(got, ref_k, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_x, rtol=2e-2, atol=2e-2 * np.abs(ref_x).max())
    # int4_matmul over leading dims, the public entry
    got2 = T.int4_matmul(torch.from_numpy(x).view(rows, 1, 200), tw, out_dtype=torch.float32)
    np.testing.assert_array_equal(np32(got2).reshape(rows, 300), got)


def test_prologue_and_epilogues_match_the_reference_composition():
    """rmsnorm prologue, residual and SwiGLU epilogues == the reference's
    rms_norm / int4_matmul / silu composition (its CPU fallback path)."""
    from dynam3d_tpu.models.vlm import phi3 as jphi3

    rng = np.random.default_rng(5)
    D, I = 128, 256
    jgu, tgu = _pair(D, 2 * I, 64, 64, seed=1)
    x = rng.normal(size=(3, D)).astype(np.float32)
    ln = (1 + 0.1 * rng.normal(size=D)).astype(np.float32)
    h = jphi3.rms_norm(jnp.asarray(ln), jnp.asarray(x, jnp.bfloat16), 1e-5)
    y = P.int4_matmul(h, jgu, out_dtype=jnp.float32)
    gate, up = jnp.split(y, 2, axis=-1)
    ref = np.asarray(jax.nn.silu(gate) * up, np.float32)
    got = T.int4_matvec(torch.from_numpy(x).to(torch.bfloat16), tgu,
                        ln_w=torch.from_numpy(ln), eps=1e-5, epilogue="swiglu")
    np.testing.assert_allclose(np32(got), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())

    jo, to = _pair(D, D, 64, 64, seed=2)
    res = rng.normal(size=(3, D)).astype(np.float32)
    ref = np.asarray(P.int4_matmul(jnp.asarray(x), jo, out_dtype=jnp.float32)) + res
    got = T.int4_matvec(torch.from_numpy(x), to, residual=torch.from_numpy(res),
                        epilogue="residual")
    np.testing.assert_allclose(np32(got), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


def test_matvec_checks_its_arguments():
    _, tw = _pair(64, 64, 64, 32)
    with pytest.raises(ValueError, match="rows"):
        T.int4_matvec(torch.zeros(17, 64), tw)
    with pytest.raises(ValueError, match="swiglu"):
        _, t2 = _pair(64, 40, 64, 32)
        T.int4_matvec(torch.zeros(1, 64), t2, epilogue="swiglu")
    with pytest.raises(ValueError, match="residual"):
        T.int4_matvec(torch.zeros(1, 64), tw, epilogue="residual")
