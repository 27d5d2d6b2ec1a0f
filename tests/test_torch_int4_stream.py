"""Port parity of kernels I and J (the plain versions of
``int4_stream_matvec`` and ``int4_unpack_matvec``) against the Pallas
kernels of ``tools/bench_int4_stream.py`` and ``tools/bench_int4_unpack.py``
run in interpret mode, at D = 256, N = 2048, NW = 2, dblk = 128.

The tools build their ``pallas_call`` inside ``main()``, so the kernels are
rebuilt here from the tools' own lines (cited below) with the shapes as
arguments; the stream tool's body is ``_matvec_acc``, imported from the JAX
package.  The TPU kernels leave the last weight's result in their output;
the port returns every weight's, and the last one is compared.

Tolerances: f32 outputs within 1e-5 of the output's scale (the same exact
integer x bf16 products summed in f32 in another order); w4a8 within 1e-6
of scale (its int32 sums are exact, only the f32 scaling differs);
dma-floor exactly, on the lo half the TPU writes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dynam3d_tpu.ops.pallas_decode import _matvec_acc
from dynam3d_tpu.ops.pallas_int4 import pack_int4 as jpack
from dynam3d_torch.ops import int4_stream as T
from dynam3d_torch.tools import bench_int4_stream as stream_tool
from dynam3d_torch.tools import bench_int4_unpack as unpack_tool
from tests.torch_parity import np32

D, N, NW, BP, DBLK = 256, 2048, 2, 8, 128
N2 = N // 2
G = D // DBLK


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    ws = [rng.normal(scale=0.05, size=(D, N)).astype(np.float32) for _ in range(NW)]
    packs = [jpack(jnp.asarray(w), dblk=DBLK, nblk=128) for w in ws]
    q4, sl, sh = (np.stack([np.asarray(getattr(p, a)) for p in packs])
                  for a in ("q4", "s_lo", "s_hi"))
    x = np32(jnp.asarray(rng.normal(size=(BP, D)), jnp.bfloat16))      # bf16 values
    return ws, q4, sl, sh, x


def _dense(q4, sl, sh, w):
    """The exact dequantized weight w of the pack, [D, N] float64."""
    b = q4[w].astype(np.int64)
    lo, hi = (b & 15) - 8, b >> 4
    s_lo = np.repeat(sl[w], DBLK, axis=0)
    s_hi = np.repeat(sh[w], DBLK, axis=0)
    return np.concatenate([lo * s_lo.astype(np.float64), hi * s_hi.astype(np.float64)], 1)


def _torch(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# --- tools/bench_int4_stream.py:66-116 (kernel_idx, matvec), shapes as arguments
def _stream_pallas(xq, q4, sl, sh, *, S, nblk):
    n2 = q4.shape[2]

    def kernel_idx(x_ref, sl_ref, sh_ref, q4_hbm, y_ref, wbuf, wsem):
        w = pl.program_id(0)
        nb = n2 // nblk

        def dma(slot, jb):
            return pltpu.make_async_copy(
                q4_hbm.at[w, :, pl.ds(jb * nblk, nblk)], wbuf.at[slot], wsem.at[slot])

        for k in range(S - 1):
            if k < nb:
                dma(k, k).start()

        def body(jb, _):
            slot = jax.lax.rem(jb, S)

            @pl.when(jb + S - 1 < nb)
            def _():
                dma(jax.lax.rem(jb + S - 1, S), jb + S - 1).start()

            dma(slot, jb).wait()
            _matvec_acc(x_ref, wbuf.at[slot], sl_ref, sh_ref, y_ref,
                        jb=jb, dblk=DBLK, nblk=nblk, n2=n2)
            return 0

        jax.lax.fori_loop(0, nb, body, 0, unroll=False)

    return pl.pallas_call(
        kernel_idx,
        grid=(NW,),
        in_specs=[
            pl.BlockSpec((BP, D), lambda w: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((None, G, n2), lambda w: (w, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((None, G, n2), lambda w: (w, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((BP, 2 * n2), lambda w: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((BP, 2 * n2), jnp.float32),
        scratch_shapes=[pltpu.VMEM((S, D, nblk), jnp.int8), pltpu.SemaphoreType.DMA((S,))],
        interpret=True,
    )(xq, sl, sh, q4)


# --- tools/bench_int4_unpack.py:71-140 (the four bodies) and :149-195 (kernel, matvec)
def _bodies(nblk):
    def body_current(x_ref, wblk, sl_ref, sh_ref, y_ref, jb):
        def chunk(i, carry):
            acc_lo, acc_hi = carry
            qi = wblk[pl.ds(i * DBLK, DBLK), :].astype(jnp.int32)
            lo = (qi << 28) >> 28
            hi = (qi << 24) >> 28
            xc = x_ref[:, pl.ds(i * DBLK, DBLK)]
            p_lo = jnp.dot(xc, lo.astype(xc.dtype), preferred_element_type=jnp.float32)
            p_hi = jnp.dot(xc, hi.astype(xc.dtype), preferred_element_type=jnp.float32)
            acc_lo = acc_lo + p_lo * sl_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            acc_hi = acc_hi + p_hi * sh_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            return acc_lo, acc_hi
        z = jnp.zeros((BP, nblk), jnp.float32)
        acc_lo, acc_hi = jax.lax.fori_loop(0, G, chunk, (z, z))
        y_ref[:, pl.ds(jb * nblk, nblk)] = acc_lo
        y_ref[:, pl.ds(N2 + jb * nblk, nblk)] = acc_hi

    def body_andtrick(x_ref, wblk, sl_ref, sh_ref, y_ref, jb):
        def chunk(i, carry):
            acc_lo, acc_hi = carry
            b = wblk[pl.ds(i * DBLK, DBLK), :]
            lo_u = b & jnp.int8(15)
            xc = x_ref[:, pl.ds(i * DBLK, DBLK)]
            sumx = jnp.sum(xc.astype(jnp.float32), -1, keepdims=True)
            p_b = jnp.dot(xc, b.astype(xc.dtype), preferred_element_type=jnp.float32)
            p_lo = jnp.dot(xc, lo_u.astype(xc.dtype), preferred_element_type=jnp.float32)
            sl = sl_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            sh = sh_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            acc_lo = acc_lo + (p_lo - 8.0 * sumx) * sl
            acc_hi = acc_hi + (p_b - p_lo) * (0.0625 * sh)
            return acc_lo, acc_hi
        z = jnp.zeros((BP, nblk), jnp.float32)
        acc_lo, acc_hi = jax.lax.fori_loop(0, G, chunk, (z, z))
        y_ref[:, pl.ds(jb * nblk, nblk)] = acc_lo
        y_ref[:, pl.ds(N2 + jb * nblk, nblk)] = acc_hi

    def body_w4a8(x_ref, wblk, sl_ref, sh_ref, y_ref, jb):
        def chunk(i, carry):
            acc_lo, acc_hi = carry
            b = wblk[pl.ds(i * DBLK, DBLK), :]
            lo_u = b & jnp.int8(15)
            xc = x_ref[:, pl.ds(i * DBLK, DBLK)]
            sumx = jnp.sum(xc.astype(jnp.int32), -1, keepdims=True)
            p_b = jnp.dot(xc, b, preferred_element_type=jnp.int32)
            p_lo = jnp.dot(xc, lo_u, preferred_element_type=jnp.int32)
            sl = sl_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            sh = sh_ref[pl.ds(i, 1), pl.ds(jb * nblk, nblk)]
            acc_lo = acc_lo + (p_lo - 8 * sumx).astype(jnp.float32) * sl
            acc_hi = acc_hi + (p_b - p_lo).astype(jnp.float32) * (0.0625 * sh)
            return acc_lo, acc_hi
        z = jnp.zeros((BP, nblk), jnp.float32)
        acc_lo, acc_hi = jax.lax.fori_loop(0, G, chunk, (z, z))
        y_ref[:, pl.ds(jb * nblk, nblk)] = acc_lo
        y_ref[:, pl.ds(N2 + jb * nblk, nblk)] = acc_hi

    def body_floor(x_ref, wblk, sl_ref, sh_ref, y_ref, jb):
        y_ref[:, pl.ds(jb * nblk, nblk)] = wblk[0:8, :].astype(jnp.float32)

    return {"dma-floor": body_floor, "current": body_current, "andtrick": body_andtrick,
            "w4a8": body_w4a8}


def _unpack_pallas(xq, q4, sl, sh, *, name, S=2, nblk=512):
    body = _bodies(nblk)[name]

    def kernel(x_ref, sl_ref, sh_ref, q4_hbm, y_ref, wbuf, wsem):
        w = pl.program_id(0)
        nb = N2 // nblk

        def dma(slot, jb):
            return pltpu.make_async_copy(
                q4_hbm.at[w, :, pl.ds(jb * nblk, nblk)], wbuf.at[slot], wsem.at[slot])

        dma(0, 0).start()

        def loop(jb, _):
            slot = jax.lax.rem(jb, S)

            @pl.when(jb + 1 < nb)
            def _():
                dma(jax.lax.rem(jb + 1, S), jb + 1).start()

            dma(slot, jb).wait()
            body(x_ref, wbuf.at[slot], sl_ref, sh_ref, y_ref, jb)
            return 0

        jax.lax.fori_loop(0, nb, loop, 0, unroll=False)

    return pl.pallas_call(
        kernel,
        grid=(NW,),
        in_specs=[
            pl.BlockSpec((BP, D), lambda w: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((None, G, N2), lambda w: (w, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((None, G, N2), lambda w: (w, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((BP, N), lambda w: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((BP, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((S, D, nblk), jnp.int8), pltpu.SemaphoreType.DMA((S,))],
        interpret=True,
    )(xq, sl, sh, q4)


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("S,nblk", T.STREAM_VARIANTS)
def test_stream_plain_matches_pallas_interpret(weights, S, nblk):
    ws, q4, sl, sh, x = weights
    ref = np.asarray(_stream_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q4),
                                    jnp.asarray(sl), jnp.asarray(sh), S=S, nblk=nblk))
    tx, tq, tsl, tsh = _torch(x, q4, sl, sh)
    got = np32(T.int4_stream_matvec(tx.to(torch.bfloat16), tq, tsl, tsh, S=S, nblk=nblk,
                                    dblk=DBLK))
    assert got.shape == (NW, BP, N)
    _close(got[-1], ref, 1e-5)
    # every weight's row block is that weight's dense product
    for w in range(NW):
        _close(got[w], x.astype(np.float64) @ _dense(q4, sl, sh, w), 1e-5)


@pytest.mark.parametrize("body", T.UNPACK_BODIES)
def test_unpack_plain_matches_pallas_interpret(weights, body):
    """Each body fed the byte format it decodes."""
    ws, q4, sl, sh, x = weights
    qb = unpack_tool.feed(body, torch.from_numpy(q4)).numpy()
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if body == "w4a8":
        tx = unpack_tool.quantize_rows(tx)[0]
    xj = jnp.asarray(tx.numpy()) if body == "w4a8" else jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(_unpack_pallas(xj, jnp.asarray(qb), jnp.asarray(sl), jnp.asarray(sh),
                                    name=body))
    got = np32(T.int4_unpack_matvec(tx, *_torch(qb, sl, sh), body=body, dblk=DBLK))[-1]
    if body == "dma-floor":
        np.testing.assert_array_equal(got[:, :N2], ref[:, :N2])
        assert not got[:, N2:].any()
    else:
        _close(got, ref, 1e-6 if body == "w4a8" else 1e-5)


def test_reference_tool_feeding_is_stale(weights):
    """``tools/bench_int4_unpack.py:234`` passes the biased-lo pack to the
    shift body, which decodes signed-lo bytes: its lo half is off; fed
    ``q4 ^ 8`` it is the dense product."""
    ws, q4, sl, sh, x = weights
    dense = x.astype(np.float64) @ _dense(q4, sl, sh, NW - 1)
    xj, args = jnp.asarray(x, jnp.bfloat16), (jnp.asarray(sl), jnp.asarray(sh))
    as_fed = np.asarray(_unpack_pallas(xj, jnp.asarray(q4), *args, name="current"))
    right = np.asarray(_unpack_pallas(xj, jnp.asarray(q4) ^ jnp.int8(8), *args, name="current"))
    _close(right, dense, 1e-5)
    assert np.abs(as_fed[:, :N2] - dense[:, :N2]).max() > 0.1 * np.abs(dense).max()
    _close(as_fed[:, N2:], dense[:, N2:], 1e-5)          # the hi nibble is right either way


def test_quantize_rows_matches_the_tool_chain():
    """The w4a8 chain's per-row activation quantisation (:200-208)."""
    x = jnp.asarray(np.random.default_rng(3).normal(size=(BP, D)), jnp.bfloat16)
    am = jnp.max(jnp.abs(x.astype(jnp.float32)), -1, keepdims=True)
    sx = am / 127.0
    xi = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    ti, tsx = unpack_tool.quantize_rows(torch.from_numpy(np.asarray(x.astype(jnp.float32))))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))


def test_tool_chains_and_check_run_on_the_plain_versions():
    x, q4, sl, sh = stream_tool.make_weights(D, N, NW, DBLK, seed=1, device="cpu")
    assert unpack_tool.check(x, q4, sl, sh, DBLK, log=lambda s: None) < 1e-4
    for body in T.UNPACK_BODIES:
        out = unpack_tool.make_chain(2, body=body, dblk=DBLK)(x, q4, sl, sh)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
    out = stream_tool.make_chain(2, S=4, nblk=256, dblk=DBLK)(x, q4, sl, sh)
    assert torch.isfinite(out.float()).all()


def test_stage_and_split_rows():
    """A ring slot is the body's 64-row box; check_stages raises for stage
    widths, slot counts and scale groups the kernels do not take; kslice
    splits D until the work items fill the card's resident blocks, at the
    tools' full shapes on 132 SMs (blocks per SM as an NVIDIA H100 80GB
    HBM3 reports them for each variant)."""
    per_sm = {(2, 512): 2, (3, 512): 1, (4, 512): 1, (4, 256): 2, (6, 256): 1, (8, 128): 2}
    for S, nblk in T.STREAM_VARIANTS:
        T.check_stages(S, nblk, 1024)
        kc = T.KC
        assert 1024 % kc == 0
        slots = 132 * per_sm[(S, nblk)]
        ks = T.split_rows(4, 3072, 8192, 1024, nblk, kc, slots)
        assert T.work_items(4, 3072, 8192, nblk, ks) >= slots and 1024 % ks == 0
        assert ks == 1024 or T.work_items(4, 3072, 8192, nblk, 2 * ks) < slots
        assert ks % kc == 0
    assert T.split_rows(4, 3072, 8192, 1024, 512, 64, 264) == 512
    assert T.split_rows(4, 3072, 8192, 1024, 512, 64, 132) == 1024
    with pytest.raises(ValueError, match="nblk must be"):
        T.check_stages(2, 384, 1024)
    with pytest.raises(ValueError, match="S must be"):
        T.check_stages(9, 512, 1024)
    with pytest.raises(ValueError, match="multiple"):
        T.check_stages(2, 512, 96)


def test_slope_timing_needs_the_card():
    x, q4, sl, sh = stream_tool.make_weights(D, N, 1, DBLK, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_tool.slope_us(lambda n: stream_tool.make_chain(n, S=2, nblk=512, dblk=DBLK),
                             (x, q4, sl, sh), 1)
