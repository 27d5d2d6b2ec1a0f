"""The tensor-core body of kernels A, E and F (``csrc/int4_mma.cuh``),
emulated lane by lane on the CPU, since the kernel itself runs only on the
card.

The emulation follows the kernel's steps with its constants: the 32-bit
words a lane reads (columns 4g..4g+3 at K rows 2t, 2t+1, 2t+8, 2t+9 of a
k16 step, at their offsets in the TMA's 128-byte swizzled slot), the byte
permutes that pair K neighbours of one column, the
0x4300 nibble -> bf16 conversion with its bf16x2 FMA by -136, the m16n8k16
lane -> (row, k) maps of the PTX ISA for the A, B (ldmatrix) and C
fragments, and the C fragment -> (row, column) map of the epilogue.  An
emulated matvec assembled from those tiles is held against
``int4_matvec_plain`` and the JAX ``_pallas_int4_matmul`` in interpret mode
on the same numpy inputs.

Tolerance: the products are exact (integer nibble x bf16) on every side;
only the f32 summation order differs, so 1e-5 absolute on outputs of
magnitude ~1, as ``test_torch_int4.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.ops import pallas_int4 as P
from dynam3d_torch.ops import int4 as T

HEADER = Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc" / "int4_mma.cuh"

# the kernel's constants (int4_mma.cuh)
EXP128 = 0x43004300       # bf16 128.0 in both halves: OR'd under a nibble
HI_XOR = 0x43084308       # 128.0 exponent | flip bit 3 of the signed hi nibble
ONE2 = 0x3F803F80         # bf16x2 1.0
MINUS136 = 0xC308C308     # bf16x2 -136.0
NIB_MASK = 0x000F000F
PAIR_K01_C01 = 0x5140     # transpose: columns 4g, 4g+1 of two K rows
PAIR_K01_C23 = 0x7362     # columns 4g+2, 4g+3
SEL_BYTES01 = 0x4140      # bytes 0, 1 into the halves' low bytes
SEL_BYTES23 = 0x4342      # bytes 2, 3
COLS, KC, CONSUMER_WARPS = 128, 64, 4
SWIZZLE_ATOM_ROWS = 8     # 128-byte swizzle: chunk j of row r lands at j ^ (r % 8)

LANES = np.arange(32, dtype=np.int64)
G, TQ = LANES >> 2, LANES & 3


def test_constants_are_the_kernels():
    src = HEADER.read_text()
    for c in (EXP128, HI_XOR, ONE2, MINUS136, NIB_MASK, PAIR_K01_C01, PAIR_K01_C23,
              SEL_BYTES01, SEL_BYTES23):
        assert re.search(rf"0x0*{c:X}u?\b", src, re.IGNORECASE), hex(c)
    for name, v in (("kCols", COLS), ("kKc", KC)):
        assert re.search(rf"constexpr int {name} = {v};", src), name


def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)``: result byte i = byte ((sel >> 4i) & 7) of
    the 8 bytes b:a (a's bytes 0-3, b's 4-7)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def bf16_halves(v):
    """bf16x2 register -> the two floats (low half first)."""
    lo = ((v & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (v & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return np.stack([lo, hi], -1)


def minus136(v):
    """``fma.rn.bf16x2 v * 1.0 + (-136.0)``: exact for 128..143, so the f32
    result is the bf16 one."""
    return bf16_halves(v) * bf16_halves(np.uint32(ONE2)) + bf16_halves(np.uint32(MINUS136))


def nibbles(p, sel):
    s = byte_perm(p, np.zeros_like(p), sel)
    return minus136((s & NIB_MASK) | EXP128), minus136(((s >> 4) & NIB_MASK) ^ HI_XOR)


def a_frags(w0, w1, w2, w3):
    """Lane registers of the four M tiles (lo0, lo1, hi0, hi1), each [4
    registers][lane][2 halves]."""
    p01, p23 = byte_perm(w0, w1, PAIR_K01_C01), byte_perm(w0, w1, PAIR_K01_C23)
    q01, q23 = byte_perm(w2, w3, PAIR_K01_C01), byte_perm(w2, w3, PAIR_K01_C23)
    a = [[None] * 4 for _ in range(4)]
    for j, (p, q) in enumerate(((p01, q01), (p23, q23))):
        for r, (word, sel) in enumerate(((p, SEL_BYTES01), (p, SEL_BYTES23),
                                         (q, SEL_BYTES01), (q, SEL_BYTES23))):
            a[j][r], a[2 + j][r] = nibbles(word, sel)
    return a


def a_matrix(regs):
    """PTX m16n8k16 A fragment (row-major 16 x 16): a0 = (g, 2t..2t+1),
    a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)."""
    A = np.zeros((16, 16), np.float32)
    for r, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in range(2):
            A[G + dm, 2 * TQ + dk + h] = regs[r][:, h]
    return A


def b_matrix(xs, nt, k):
    """ldmatrix of x rows 8nt..8nt+7, K k..k+15: thread i gets row i / 4,
    elements 2(i % 4), +1 of each 8 x 8 matrix; b0 = K k.., b1 = K k+8..
    The PTX B fragment (16 x 8, K x N): b0 = (2t..2t+1, g), b1 = (2t+8.., g)."""
    b0 = np.stack([xs[8 * nt + G, k + 2 * TQ], xs[8 * nt + G, k + 2 * TQ + 1]], -1)
    b1 = np.stack([xs[8 * nt + G, k + 8 + 2 * TQ], xs[8 * nt + G, k + 9 + 2 * TQ]], -1)
    B = np.zeros((16, 8), np.float32)
    for dk, reg in ((0, b0), (8, b1)):
        for h in range(2):
            B[2 * TQ + dk + h, G] = reg[:, h]
    return B


def c_regs(D):
    """PTX C fragment (16 x 8): c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t),
    c3 = (g+8, 2t+1); -> [4 registers][lane]."""
    return np.stack([D[G, 2 * TQ], D[G, 2 * TQ + 1], D[G + 8, 2 * TQ], D[G + 8, 2 * TQ + 1]])


def words(q4p, k, col):
    """The lane's 32-bit little-endian word of columns col..col+3 at K row k."""
    b = q4p[k[:, None], col[:, None] + np.arange(4)].astype(np.uint32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def emulated_matvec(x_bf16, q4, s_lo, s_hi, dblk, rows):
    """The tensor-core body at ks = dblk (one scale group per block: kernel
    E's plan, and kernel A's wherever A takes whole groups), store
    epilogue, f32 out [rows, 2 * n2]."""
    dp, n2 = q4.shape
    nt_count = 1 if rows <= 8 else 2
    tiles = -(-n2 // COLS)
    # the ring slot past n2 holds stale bytes: random ones must not reach the output
    q4p = np.random.default_rng(99).integers(0, 256, (dp, tiles * COLS)).astype(np.uint8)
    q4p[:, :n2] = q4.view(np.uint8)
    xs = np.zeros((8 * nt_count, dp), np.float32)
    xs[:rows, : x_bf16.shape[1]] = x_bf16
    out = np.zeros((rows, 2 * n2), np.float32)
    for tile in range(tiles):
        col0 = tile * COLS
        for w in range(CONSUMER_WARPS):
            col = col0 + 32 * w + 4 * G                                      # [lane]
            partial = []
            for grp in range(dp // dblk):
                acc = np.zeros((nt_count, 4, 4, 32), np.float32)             # [nt][M tile][e][lane]
                for k16 in range(grp * dblk, (grp + 1) * dblk, 16):
                    k = k16 + 2 * TQ
                    a = a_frags(words(q4p, k, col), words(q4p, k + 1, col),
                                words(q4p, k + 8, col), words(q4p, k + 9, col))
                    for nt in range(nt_count):
                        B = b_matrix(xs, nt, k16)
                        for m in range(4):
                            acc[nt, m] += c_regs(a_matrix(a[m]) @ B)
                # scale(): the group's scales of the lane's four columns
                lc = col[None, :] + np.arange(4)[:, None]                    # [jj][lane]
                ok = lc < n2
                sl = np.where(ok, s_lo[grp, np.minimum(lc, n2 - 1)], 0.0)
                sh = np.where(ok, s_hi[grp, np.minimum(lc, n2 - 1)], 0.0)
                partial.append((acc, sl, sh))
            # combine(): slices summed in order, then the store epilogue via acc_at
            for rs in range(2 * nt_count):
                r = 2 * TQ + 8 * (rs >> 1) + (rs & 1)
                for jj in range(4):
                    c = col + jj
                    lo = np.zeros(32, np.float32)
                    hi = np.zeros(32, np.float32)
                    for acc, sl, sh in partial:
                        e = 2 * (jj & 1) + (rs & 1)
                        lo = lo + acc[rs >> 1, jj >> 1, e] * sl[jj]
                        hi = hi + acc[rs >> 1, 2 + (jj >> 1), e] * sh[jj]
                    keep = (r < rows) & (c < n2)
                    out[r[keep], c[keep]] = lo[keep]
                    out[r[keep], n2 + c[keep]] = hi[keep]
    return out


def tma_swizzled(box):
    """A [KC, COLS] byte box as the TMA's 128-byte swizzle lays it out in a
    1024-byte aligned slot: 16-byte chunk j of row r at chunk j ^ (r % 8)."""
    out = np.empty_like(box)
    for r in range(box.shape[0]):
        for j in range(COLS // 16):
            jj = j ^ (r % SWIZZLE_ATOM_ROWS)
            out[r, 16 * jj: 16 * jj + 16] = box[r, 16 * j: 16 * j + 16]
    return out.reshape(-1)


def lane_offsets(warp):
    """The kernel's swizzled byte offsets of a lane's words at rows 2t and
    2t + 1 of a k16 step (``consume`` in int4_mma.cuh)."""
    chunk, in_chunk = 2 * warp + (G >> 2), 4 * (G & 3)
    off0 = 2 * TQ * COLS + ((chunk ^ (2 * TQ)) << 4) + in_chunk
    off1 = (2 * TQ + 1) * COLS + ((chunk ^ (2 * TQ + 1)) << 4) + in_chunk
    return off0, off1


def test_swizzled_reads_are_the_logical_words_on_distinct_banks():
    box = np.random.default_rng(3).integers(0, 256, (KC, COLS)).astype(np.uint8)
    slot = tma_swizzled(box)
    for w in range(CONSUMER_WARPS):
        off0, off1 = lane_offsets(w)
        col = 32 * w + 4 * G
        for q in range(KC // 16):
            for off, dk in ((off0, 0), (off1, 1), (off0 + 8 * COLS, 8), (off1 + 8 * COLS, 9)):
                addr = q * 16 * COLS + off
                got = slot[addr[:, None] + np.arange(4)]
                np.testing.assert_array_equal(got, box[(16 * q + 2 * TQ + dk)[:, None],
                                                        col[:, None] + np.arange(4)])
                assert len(set((addr // 4) % 32)) == 32        # one load, 32 banks


def test_nibble_conversion_all_bytes():
    """Every byte value through the permute + 0x4300 conversion gives the
    nibbles ``unpack_nibbles`` gives."""
    b = np.arange(256, dtype=np.int64)
    lo_ref, hi_ref = (t.numpy() for t in T.unpack_nibbles(torch.from_numpy(b.astype(np.int8))))
    # bytes b (K row 2t) and b ^ 0x5a (K row 2t+1) of one column, as a lane pairs them
    w0, w1 = b.astype(np.uint32), (b ^ 0x5A).astype(np.uint32)
    lo, hi = nibbles(byte_perm(w0, w1, PAIR_K01_C01), SEL_BYTES01)
    lo_ref2, hi_ref2 = (t.numpy() for t in T.unpack_nibbles(
        torch.from_numpy((b ^ 0x5A).astype(np.int8))))
    np.testing.assert_array_equal(lo[:, 0], lo_ref)
    np.testing.assert_array_equal(hi[:, 0], hi_ref)
    np.testing.assert_array_equal(lo[:, 1], lo_ref2)
    np.testing.assert_array_equal(hi[:, 1], hi_ref2)


@pytest.mark.parametrize("rows", [1, 5, 8, 12, 16])
def test_emulated_tensor_core_matvec(rows):
    rng = np.random.default_rng(40 + rows)
    d, n, dblk, nblk = 200, 300, 64, 64
    w = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    tw = T.pack_int4(torch.from_numpy(w), dblk=dblk, nblk=nblk)
    jw = P.pack_int4(jnp.asarray(w), dblk=dblk, nblk=nblk)
    assert tw.n2 % 16 == 0 and tw.n2 % COLS != 0        # a ragged last column tile
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    got = emulated_matvec(xb, tw.q4.numpy(), tw.s_lo.numpy(), tw.s_hi.numpy(), dblk, rows)[:, :n]
    plain = T.int4_matvec_plain(torch.from_numpy(x), tw).numpy()
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 16 - rows), (0, jw.dp - d)))
    ref_k = np.asarray(P._pallas_int4_matmul(xp, jw, interpret=True))[:rows, :n]
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_k, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 8, 9, 16])
def test_emulated_grid2d_plan(rows):
    """Kernel E: g = 3 scale groups of dblk = 128 rows (two kKc stages each),
    a block per (128-column tile, group), the groups summed in order;
    rows 1 and 8 take one n8 tile, 9 and 16 two."""
    rng = np.random.default_rng(70 + rows)
    d, n, dblk, nblk = 384, 300, 128, 64
    w = rng.normal(scale=0.02, size=(d, n)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    tw = T.pack_int4(torch.from_numpy(w), dblk=dblk, nblk=nblk)
    jw = P.pack_int4(jnp.asarray(w), dblk=dblk, nblk=nblk)
    assert tw.dp // dblk == 3 and dblk % KC == 0 and tw.n2 % COLS != 0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = emulated_matvec(xb.float().numpy(), tw.q4.numpy(), tw.s_lo.numpy(), tw.s_hi.numpy(),
                          dblk, rows)[:, :n]
    plain = T.int4_matvec2d_plain(torch.from_numpy(x), tw).numpy()
    xp = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 16 - rows), (0, 0)))
    ref_k = np.asarray(P._pallas_int4_matmul2d(xp, jw, interpret=True))[:rows, :n]
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_k, rtol=0, atol=1e-5)
