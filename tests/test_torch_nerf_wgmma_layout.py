"""Kernel C's shared-memory layouts (``csrc/nerf_mlp.cu``), emulated in numpy
on the CPU, since the kernel itself runs only on the card.

Three address functions, with the constants read from the source:

* the 128-byte swizzle of a weight slot (as the TMA writes a [BN, 64] box)
  and of the activation tile (``sw128``): 16-byte chunk j of a 128-byte row
  r at chunk j ^ (r % 8);
* the element -> address map of a wgmma matrix descriptor (``desc``: start
  address, leading and stride byte offsets, swizzle mode), as the hardware
  forms it for a K-major operand: row m of a k16 step at start + (m / 8) *
  SBO + (m % 8) * 128 + 2k, then the 128-byte swizzle of the address bits;
* the epilogue's write addresses into every cluster block's tile: the wgmma
  accumulator's register -> (row, column) map of the PTX ISA for each of the
  two consumer warpgroups (each owns half of a block's columns), the
  bf16x2 words of four n8 groups transposed over a quad of lanes
  (``quad_transpose``), then ``sw128`` of each lane's 16-byte chunk.

A chain assembled from them -- the activation tile staged, per layer the
weight K-tiles landed by the TMA, every k16 step's A and B gathered through
their descriptors, the accumulators written through the exchange into the
tiles of every block of the cluster, the density read back through
``sw128`` -- is held against ``nerf_mlp_plain`` and the JAX
``fused_nerf_mlp`` in interpret mode at D = 256 (clusters of two
128-column blocks) and D = 384 (two 192-column blocks) with a ragged N.

Tolerance: one bf16 step (2**-7 relative, as ``test_torch_render.py``
states it) at each output's scale, its largest magnitude: the same bf16
roundings of sums taken in another order, where a hidden value now and
then rounds one step the other way and moves its row's later sums by a
fraction of a step (at D = 256 the plain version and the TPU kernel differ
so on 52 of 25,856 outputs, by at most 0.0078 on a scale of ~2; measured
on the CPU).  The cache of the kernel's bf16 weights is held to its
staleness rule: an in-place update gives fresh copies.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.ops.pallas_mlp import fused_nerf_mlp
from dynam3d_torch.ops import nerf_mlp as T

SRC = (Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc" / "nerf_mlp.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


ROWS, BK, KSTEP = _const("kRows"), _const("kBK"), _const("kKStep")
ROW_BYTES, SBO, LBO, SWIZZLE = (_const("kRowBytes"), _const("kSbo"), _const("kLbo"),
                                _const("kSwizzle128"))
GROUPS, LAYERS = _const("kConsumerGroups"), _const("kLayers")
CONSUMERS = 128 * GROUPS
KBLOCK_BYTES = ROWS * ROW_BYTES


def cols_of(D: int) -> int:
    m = re.search(r"cols_of\(int D\) \{ return D % (\d+) == 0 \? (\d+) : (\d+); \}", SRC)
    assert m
    div, big, small = (int(g) for g in m.groups())
    return big if D % div == 0 else small


def sw128(r, k, block_bytes):
    """``sw128`` of the kernel: byte offset of element (r, k) of a K-major
    tile of [rows, 64] bf16 K-blocks with the 128-byte swizzle."""
    return (k // BK) * block_bytes + r * ROW_BYTES + ((((k % BK) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2


def tma_box(box):
    """A [rows, 64] bf16 box as the TMA writes it with the 128-byte swizzle
    into a 1024-byte aligned slot: 16-byte chunk j of row r at j ^ (r % 8)."""
    rows = box.shape[0]
    slot = np.zeros(rows * ROW_BYTES // 2, np.uint16)
    for r in range(rows):
        for j in range(ROW_BYTES // 16):
            jj = j ^ (r % 8)
            slot[(r * ROW_BYTES + 16 * jj) // 2:(r * ROW_BYTES + 16 * jj + 16) // 2] = \
                box[r, 8 * j:8 * j + 8]
    return slot


def desc(saddr: int) -> int:
    """``desc`` of the kernel."""
    return (((saddr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32)
            | (SWIZZLE << 62))


def desc_addresses(d: int, rows: int) -> np.ndarray:
    """Byte addresses [rows, KSTEP] the hardware reads for a K-major operand
    with the 128-byte swizzle at descriptor d: start + (m / 8) * SBO +
    (m % 8) * 128 + 2k, address bits 4-6 xor'ed with bits 7-9."""
    start = (d & 0x3FFF) << 4
    sbo = ((d >> 32) & 0x3FFF) << 4
    assert (d >> 62) & 3 == 1                       # 128-byte swizzle
    m = np.arange(rows)[:, None]
    k = np.arange(KSTEP)[None, :]
    addr = start + (m // 8) * sbo + (m % 8) * ROW_BYTES + 2 * k
    return addr ^ (((addr >> 7) & 7) << 4)


def acc_rows_cols(bn: int):
    """wgmma accumulator map (PTX ISA, m64nN f32 D) of the consumer
    warpgroups, warpgroup g = t / 128 on columns g * WN .. +WN (WN = bn /
    GROUPS): thread t, register i -> row 16 * (t % 128 / 32) + (t % 32) / 4
    + 8 * ((i / 2) % 2), column g * WN + 8 * (i / 4) + 2 * (t % 4) + i % 2.
    Arrays [thread, register]."""
    wn = bn // GROUPS
    t = np.arange(CONSUMERS)[:, None]
    i = np.arange(wn // 2)[None, :]
    row = 16 * (t % 128 // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)
    col = (t // 128) * wn + 8 * (i // 4) + 2 * (t % 4) + i % 2
    return row, col


def exchange(values, bn: int, c0: int):
    """The epilogue's stores of one block into a tile: values [thread,
    register] (f32, as the accumulators hold them after the epilogue math)
    -> (uint16 element offsets [store, 8], bf16 bits [store, 8]).  Per
    (four n8 groups 4g..4g+3, h): quad_transpose hands lane q of a quad the
    bf16x2 word of n8 group 4g + q at row rA + 8h from each lane i of the
    quad, and the lane stores that 16-byte chunk at sw128(row, c0 + cw + 8 *
    (4g + q))."""
    wn = bn // GROUPS
    row, _ = acc_rows_cols(bn)
    bits = bf16_bits(values)                                   # [thread, register]
    t = np.arange(CONSUMERS)
    quad0, q, cw = t - t % 4, t % 4, (t // 128) * wn
    offs, data = [], []
    for g in range(wn // 32):
        for h in range(2):
            reg = 4 * (4 * g + q) + 2 * h                      # the word's first register
            chunk = np.stack([bits[quad0 + i, reg + e] for i in range(4) for e in range(2)], 1)
            base = sw128(row[t, 2 * h], c0 + cw + 8 * (4 * g + q), KBLOCK_BYTES)
            assert (base % 16 == 0).all()
            offs.append(base[:, None] // 2 + np.arange(8))
            data.append(chunk)
    return np.concatenate(offs), np.concatenate(data)


def bf16_bits(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bits_f32(b: np.ndarray) -> np.ndarray:
    return (b.astype(np.uint32) << 16).view(np.float32)


def leaky(v):
    return np.where(v >= 0, v, np.float32(0.01) * v).astype(np.float32)


def test_constants_and_plan():
    assert (ROWS, BK, KSTEP, ROW_BYTES, SBO) == (64, 64, 16, 128, 1024)
    assert cols_of(768) == 192 and cols_of(1024) == 128 and cols_of(384) == 192
    assert SBO == 8 * ROW_BYTES                  # one 8-row atom of the swizzle to the next


@pytest.mark.parametrize("bn", [128, 192])
def test_swizzle_descriptors_and_exchange(bn):
    """The TMA slot and the activation tile read back through sw128 and
    through every descriptor the kernel issues; the exchange's 4-byte
    writes of a warp fall on 32 distinct banks."""
    rng = np.random.default_rng(bn)
    box = rng.integers(0, 2**16, (bn, BK)).astype(np.uint16)
    slot = tma_box(box)
    n, k = np.meshgrid(np.arange(bn), np.arange(BK), indexing="ij")
    np.testing.assert_array_equal(slot[sw128(n, k, 0) // 2], box)
    D = 256
    tile = rng.integers(0, 2**16, (ROWS, D)).astype(np.uint16)
    act = np.zeros(ROWS * D, np.uint16)
    r, kk = np.meshgrid(np.arange(ROWS), np.arange(D), indexing="ij")
    act[sw128(r, kk, KBLOCK_BYTES) // 2] = tile
    for kt in range(D // BK):
        for s in range(BK // KSTEP):
            a = desc_addresses(desc(kt * KBLOCK_BYTES + s * 2 * KSTEP), ROWS)
            np.testing.assert_array_equal(act[a // 2], tile[:, kt * BK + s * KSTEP:][:, :KSTEP])
    for s in range(BK // KSTEP):
        b = desc_addresses(desc(s * 2 * KSTEP), bn)
        np.testing.assert_array_equal(slot[b // 2], box[:, s * KSTEP:(s + 1) * KSTEP])
    # the exchange: every element of the block's columns once, at its sw128 place
    row, col = acc_rows_cols(bn)
    vals = rng.normal(size=row.shape).astype(np.float32)
    want = np.zeros(ROWS * 2 * bn, np.uint16)
    for c0 in (0, bn):
        offs, data = exchange(vals, bn, c0)
        assert len(np.unique(offs)) == offs.size == ROWS * bn
        got = np.zeros(ROWS * 2 * bn, np.uint16)
        got[offs.ravel()] = data.ravel()
        want[sw128(row, c0 + col, KBLOCK_BYTES) // 2] = bf16_bits(vals)
        np.testing.assert_array_equal(got[offs.ravel()], want[offs.ravel()])


def emulated_chain(x, w, D):
    """Kernel C's chain on the emulated layouts: [N, D] bf16 bits out and
    [N] bf16 bits of density."""
    N = x.shape[0]
    bn = cols_of(D)
    CL, KB = D // bn, D // BK
    wt = np.concatenate([bf16_bits(t[:, :D].T) for t in w])          # [6D, D], as kernel_weights
    eo_col = bits_f32(bf16_bits(w[2][:, D]))
    row, col = acc_rows_cols(bn)
    out = np.zeros((N, D), np.uint16)
    dens = np.zeros(N, np.uint16)
    for row0 in range(0, N, ROWS):
        valid = np.arange(ROWS) + row0 < N
        xt = np.zeros((ROWS, D), np.float32)
        xt[valid] = x[row0:row0 + ROWS][: valid.sum()]
        xb = bf16_bits(xt)
        tiles = [np.zeros(KB * KBLOCK_BYTES // 2, np.uint16) for _ in range(CL)]
        r, kk = np.meshgrid(np.arange(ROWS), np.arange(D), indexing="ij")
        for tl in tiles:
            tl[sw128(r, kk, KBLOCK_BYTES) // 2] = xb
        for layer in range(LAYERS):
            regs = []
            for rank in range(CL):
                c0 = rank * bn
                acc = np.zeros((ROWS, bn), np.float32)
                for kt in range(KB):
                    slot = tma_box(wt[layer * D + c0:layer * D + c0 + bn, kt * BK:(kt + 1) * BK])
                    for s in range(BK // KSTEP):
                        a = bits_f32(tiles[rank][desc_addresses(
                            desc(kt * KBLOCK_BYTES + s * 2 * KSTEP), ROWS) // 2])
                        b = bits_f32(slot[desc_addresses(desc(s * 2 * KSTEP), bn) // 2])
                        acc += a @ b.T
                regs.append(acc[row, col])                               # [thread, register]
            if layer == 2:   # density of the EO layer's input, read through sw128
                h = bits_f32(tiles[0][sw128(r, kk, KBLOCK_BYTES) // 2])
                d = bf16_bits(leaky(h @ eo_col))
                dens[row0:row0 + ROWS][: valid.sum()] = d[valid]
            for rank in range(CL):
                c0 = rank * bn
                v = regs[rank]
                if layer == LAYERS - 1:
                    ok = valid[row]
                    out[row0 + row[ok], c0 + col[ok]] = bf16_bits(v[ok])
                    continue
                v = leaky(v)
                if layer == 2:
                    v = v + bits_f32(xb[row, c0 + col])
                offs, data = exchange(v, bn, c0)
                for dst in range(CL):                                    # every block's tile
                    tiles[dst][offs] = data
    return bits_f32(out), bits_f32(dens)


def _bf16_step(ref: np.ndarray) -> float:
    """One bf16 rounding step (8 mantissa bits) at the tensor's scale."""
    return float(np.abs(ref).max()) * 2.0 ** -7


@pytest.mark.parametrize("D", [256, 384])
def test_emulated_chain_matches_plain_and_tpu_kernel(D):
    rng = np.random.default_rng(D)
    N = ROWS + 37                                   # a full and a ragged row tile
    shapes = [(D, D), (D, D), (D, D + 1), (D, D), (D, D), (D, D)]
    w = [(rng.normal(size=s) / np.sqrt(D)).astype(np.float32) for s in shapes]
    x = rng.normal(size=(N, D)).astype(np.float32)
    got_o, got_d = emulated_chain(x, w, D)
    po, pd = T.nerf_mlp_plain(torch.from_numpy(x), *(torch.from_numpy(t) for t in w))
    jo, jd = fused_nerf_mlp(jnp.asarray(x), *(jnp.asarray(t) for t in w), tile=64,
                            interpret=True)
    for ref_o, ref_d in ((po.float().numpy(), pd.float().numpy()),
                         (np.asarray(jo, np.float32), np.asarray(jd, np.float32))):
        assert (np.abs(got_o - ref_o) <= _bf16_step(ref_o)).all()
        assert (np.abs(got_d - ref_d) <= _bf16_step(ref_d)).all()


def test_kernel_weights_follow_in_place_updates():
    rng = np.random.default_rng(5)
    D = 128
    w = [torch.from_numpy(rng.normal(size=(D, D + (i == 2))).astype(np.float32))
         for i in range(6)]
    T._weight_cache.clear()
    wt, eo_col = T.kernel_weights(w)
    want = torch.cat([t[:, :D].t().to(torch.bfloat16) for t in w])
    assert torch.equal(wt, want) and torch.equal(eo_col, w[2][:, D].to(torch.bfloat16))
    assert T.kernel_weights(w)[0] is wt                       # the same version: cached
    with torch.no_grad():
        w[3].mul_(2.0)                                         # an optimizer step, in place
    wt2, _ = T.kernel_weights(w)
    assert wt2 is not wt
    assert torch.equal(wt2[3 * D:4 * D], (w[3].t()).to(torch.bfloat16))
    w[0] = w[0] + 1.0                                          # a new tensor: a new key
    wt3, _ = T.kernel_weights(w)
    assert torch.equal(wt3[:D], w[0].t().to(torch.bfloat16))
    T._weight_cache.clear()
