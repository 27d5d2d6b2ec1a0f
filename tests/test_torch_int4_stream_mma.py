"""Kernels I and J on the tensor-core body (``csrc/int4_stream.cu`` on
``csrc/int4_mma.cuh``), emulated lane by lane on the CPU, since the kernels
run only on the card.

The emulation follows the kernels' steps with their constants: a work item
(weight, column tile of nblk, K slice) reads [64, 128] TMA boxes of the
weights stacked as one [NW * D, N2] map, 128-byte swizzled, at the lane
offsets of ``box_offsets``; the bf16 bodies build kernel A's fragments
(biased-lo for I and J's andtrick, signed-lo for J's current), w4a8 builds
s8 m16n8k32 fragments from the raw bytes and their low nibbles after the
4x4 byte transpose, against x words staged in the kernel's K order; each
slice's sums are scaled and the slices summed in order (``split_sum``).
The emulated matvecs are held against the plain versions and, for w4a8,
against the Pallas body of ``tools/bench_int4_unpack.py`` in interpret
mode (``tests/test_torch_int4_stream.py`` rebuilds it), on the same numpy
inputs; the plans of every ``STREAM_VARIANTS`` entry are checked at the
tools' shapes.

Tolerances: the bf16 bodies' products are exact (integer nibble x bf16)
and only the f32 summation order differs: 1e-5 of the output's scale, as
``chip_smoke.py``; w4a8's int32 sums are exact (held exactly), only the f32
scaling and the slice sum round: 1e-6 of scale; dma-floor exactly.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynam3d_torch.ops import int4_stream as T
from dynam3d_torch.tools import bench_int4_unpack as unpack_tool
from dynam3d_torch.tools import decompose_int4_mma, decompose_nerf_mlp
from tests.test_torch_int4_fragments import (
    COLS, G, HI_XOR, KC, NIB_MASK, PAIR_K01_C01, PAIR_K01_C23, SEL_BYTES01, SEL_BYTES23, TQ,
    a_matrix, b_matrix, byte_perm, c_regs, lane_offsets, minus136, nibbles, tma_swizzled,
)
from tests.test_torch_int4_stream import D, DBLK, N, N2, NW, _unpack_pallas, weights  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc"
STREAM_SRC = (CSRC / "int4_stream.cu").read_text()
HEADER_SRC = (CSRC / "int4_mma.cuh").read_text()
CHIP_SMOKE = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()

ROWS, WARPS = 8, 4
LOW_NIBBLES = 0x0F0F0F0F          # w4a8: b & 15 in every byte
X8_PERM_LO, X8_PERM_HI = 0x5410, 0x7632   # stage_x8: K 2t, 2t+1 | 2t+8, 2t+9 into word t
X8_PITCH = 1024 + 16              # kX8Pitch: bytes per staged int8 x row


def test_constants_are_the_kernels():
    assert "(s & 0x000F000Fu) ^ 0x43084308u" in HEADER_SRC          # signed-lo lo nibble
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in STREAM_SRC
    assert re.search(r"0x0F0F0F0Fu", STREAM_SRC)
    for sel in (X8_PERM_LO, X8_PERM_HI):
        assert f"__byte_perm(u.x, u.z, 0x{sel:X})" in STREAM_SRC
        assert f"__byte_perm(u.y, u.w, 0x{sel:X})" in STREAM_SRC
    assert "constexpr int kX8Pitch = kMaxSlice + 16;" in STREAM_SRC
    assert "void transpose4(" in HEADER_SRC and "void transpose4(" not in STREAM_SRC
    assert "a_frags<BODY == kCurrent>" in STREAM_SRC
    assert T.KC == KC and T.NBLKS == (COLS, 2 * COLS, 4 * COLS)


@pytest.mark.parametrize("tool", [decompose_int4_mma, decompose_nerf_mlp])
def test_decompose_patches_apply(tool):
    """The decomposition tools' patches still find their text in the sources
    (the stream patch of the shared header also reaches I and J through
    ``produce``)."""
    for name, patches in tool.PATCHES.items():
        for source, old, _new in patches:
            assert old in (CSRC / source).read_text(), (name, source)


# ---- fragments ----

def transpose4(w):
    """``transpose4``: w[i] = K row i of four columns -> col[j] = rows 0..3
    of column j."""
    a, b = byte_perm(w[0], w[1], PAIR_K01_C01), byte_perm(w[2], w[3], PAIR_K01_C01)
    c, d = byte_perm(w[0], w[1], PAIR_K01_C23), byte_perm(w[2], w[3], PAIR_K01_C23)
    return [byte_perm(a, b, X8_PERM_LO), byte_perm(a, b, X8_PERM_HI),
            byte_perm(c, d, X8_PERM_LO), byte_perm(c, d, X8_PERM_HI)]


def s8(v):
    """[lane] 32-bit words -> [lane, 4] signed bytes."""
    by = np.stack([(v >> (8 * i)) & 0xFF for i in range(4)], -1).astype(np.int64)
    return np.where(by >= 128, by - 256, by)


def a_matrix_s8(regs):
    """PTX m16n8k32 .s8 A fragment (16 x 32): register i holds row g + 8 (i
    % 2), K 4t + 16 (i / 2) .. + 3, one byte each."""
    A = np.zeros((16, 32), np.int64)
    for i, reg in enumerate(regs):
        by = s8(reg)
        for j in range(4):
            A[G + 8 * (i & 1), 4 * TQ + 16 * (i >> 1) + j] = by[:, j]
    return A


def b_matrix_s8(b0, b1):
    """PTX m16n8k32 .s8 B fragment (32 x 8, K x N): b0 = K 4t..4t+3 of column
    g, b1 = K 16 + 4t.."""
    B = np.zeros((32, 8), np.int64)
    for h, reg in enumerate((b0, b1)):
        by = s8(reg)
        for j in range(4):
            B[4 * TQ + 16 * h + j, G] = by[:, j]
    return B


def nibbles_signed(p, sel):
    s = byte_perm(p, np.zeros_like(p), sel)
    return minus136((s & NIB_MASK) ^ HI_XOR), minus136(((s >> 4) & NIB_MASK) ^ HI_XOR)


def a_frags(w0, w1, w2, w3, signed_lo):
    """``a_frags<kSignedLo>``: the four M tiles (lo0, lo1, hi0, hi1)."""
    nib = nibbles_signed if signed_lo else nibbles
    p01, p23 = byte_perm(w0, w1, PAIR_K01_C01), byte_perm(w0, w1, PAIR_K01_C23)
    q01, q23 = byte_perm(w2, w3, PAIR_K01_C01), byte_perm(w2, w3, PAIR_K01_C23)
    a = [[None] * 4 for _ in range(4)]
    for j, (p, q) in enumerate(((p01, q01), (p23, q23))):
        for r, (word, sel) in enumerate(((p, SEL_BYTES01), (p, SEL_BYTES23),
                                         (q, SEL_BYTES01), (q, SEL_BYTES23))):
            a[j][r], a[2 + j][r] = nib(word, sel)
    return a


def test_signed_lo_fragments_all_bytes():
    """Every signed-lo byte (J's current: the low nibble is lo & 15) through
    the permute and the ^ 0x43084308 conversion gives the signed nibbles the
    shift unpack gives (``(q << 28) >> 28``, ``q >> 4``)."""
    b = np.arange(256, dtype=np.int64)
    sb = np.where(b >= 128, b - 256, b)
    lo_ref, hi_ref = ((b & 15) ^ 8) - 8, sb >> 4
    w0, w1 = b.astype(np.uint32), (b ^ 0x5A).astype(np.uint32)
    lo, hi = nibbles_signed(byte_perm(w0, w1, PAIR_K01_C01), SEL_BYTES01)
    np.testing.assert_array_equal(lo[:, 0], lo_ref)
    np.testing.assert_array_equal(hi[:, 0], hi_ref)
    sb2 = np.where((b ^ 0x5A) >= 128, (b ^ 0x5A) - 256, b ^ 0x5A)
    np.testing.assert_array_equal(hi[:, 1], sb2 >> 4)
    # the same nibbles as the biased-lo conversion of the byte the pack wrote
    lo_b, hi_b = nibbles(byte_perm(w0 ^ 8, w1, PAIR_K01_C01), SEL_BYTES01)
    np.testing.assert_array_equal(lo[:, 0], lo_b[:, 0])
    np.testing.assert_array_equal(hi[:, 0], hi_b[:, 0])


# ---- the work items, emulated ----

def word(slot, addr):
    """Little-endian 32-bit words of the flat byte slot at [lane] addr."""
    b = slot[addr[:, None] + np.arange(4)].astype(np.int64)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def boxes(q4, w, col0, nsub, k):
    """Stage k of a work item: nsub swizzled [64, 128] boxes of the stacked
    [NW * D, N2] map at rows w * D + k .. + 64 (never past weight w)."""
    stack = q4.reshape(-1, q4.shape[2]).view(np.uint8)
    d = q4.shape[1]
    assert k + KC <= d
    return [tma_swizzled(stack[w * d + k: w * d + k + KC, col0 + COLS * b: col0 + COLS * (b + 1)])
            for b in range(nsub)]


def stage_x8(xi, k0, ks):
    """``stage_x8``: int8 x [8, D] slice -> [8, X8_PITCH] bytes with each 16
    K values' words permuted, and the row sums."""
    out = np.zeros((ROWS, X8_PITCH), np.uint8)
    u8 = xi.view(np.uint8).astype(np.uint32)
    for k in range(0, ks, 16):
        v = u8[:, k0 + k: k0 + k + 16]
        u = [v[:, 4 * i] | (v[:, 4 * i + 1] << 8) | (v[:, 4 * i + 2] << 16) | (v[:, 4 * i + 3] << 24)
             for i in range(4)]
        ws = [byte_perm(u[0], u[2], X8_PERM_LO), byte_perm(u[0], u[2], X8_PERM_HI),
              byte_perm(u[1], u[3], X8_PERM_LO), byte_perm(u[1], u[3], X8_PERM_HI)]
        for i, wv in enumerate(ws):
            for j in range(4):
                out[:, k + 4 * i + j] = (wv >> (8 * j)) & 0xFF
    return out, xi[:, k0:k0 + ks].astype(np.int64).sum(-1)


def x8_words(xq, kw):
    """B registers of lane (g, t): staged row g, words kw + t and kw + 4 + t."""
    def w(i):
        b = xq[G[:, None], 4 * i[:, None] + np.arange(4)].astype(np.int64)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return w(kw + TQ), w(kw + 4 + TQ)


def item_sums_w4a8(q4, xi, w, col0, nsub, k0, ks):
    """The int32 sums of one w4a8 work item: p_lo, p_b as [rows, nsub * 128]
    (int64 here; exact), and the slice's row sums of x."""
    xq, sumx = stage_x8(xi, k0, ks)
    p = np.zeros((2, ROWS, nsub * COLS), np.int64)
    for s in range(ks // KC):
        bx = boxes(q4, w, col0, nsub, k0 + s * KC)
        for q in range(KC // 32):
            B = b_matrix_s8(*x8_words(xq, (s * KC + 32 * q) // 4))
            for b in range(nsub):
                for warp in range(WARPS):
                    off0, off1 = lane_offsets(warp)
                    base = q * 32 * COLS
                    wa = [word(bx[b], base + o) for o in (off0, off1, off0 + 8 * COLS, off1 + 8 * COLS)]
                    wb = [word(bx[b], base + 16 * COLS + o)
                          for o in (off0, off1, off0 + 8 * COLS, off1 + 8 * COLS)]
                    ca, cb = transpose4(wa), transpose4(wb)
                    for j in range(2):
                        ab = [ca[2 * j], ca[2 * j + 1], cb[2 * j], cb[2 * j + 1]]
                        al = [v & LOW_NIBBLES for v in ab]
                        for which, regs in ((0, al), (1, ab)):
                            C = c_regs(a_matrix_s8(regs) @ B)          # [e][lane]
                            for e in range(4):
                                col = b * COLS + 32 * warp + 4 * G + 2 * j + (e >> 1)
                                p[which, 2 * TQ + (e & 1), col] += C[e]
    return p[0], p[1], sumx


def item_sums_bf16(q4, x_bf16, w, col0, nsub, k0, ks, signed_lo):
    """The f32 sums (lo, hi) of one bf16-body work item, [rows, nsub * 128]."""
    xs = x_bf16[:, k0:k0 + ks]
    acc = np.zeros((2, ROWS, nsub * COLS), np.float32)
    for s in range(ks // KC):
        bx = boxes(q4, w, col0, nsub, k0 + s * KC)
        for q in range(KC // 16):
            B = b_matrix(xs, 0, s * KC + 16 * q)
            for b in range(nsub):
                for warp in range(WARPS):
                    off0, off1 = lane_offsets(warp)
                    base = q * 16 * COLS
                    a = a_frags(*(word(bx[b], base + o)
                                  for o in (off0, off1, off0 + 8 * COLS, off1 + 8 * COLS)), signed_lo)
                    for m in range(4):
                        C = c_regs(a_matrix(a[m]) @ B)
                        for e in range(4):
                            col = b * COLS + 32 * warp + 4 * G + 2 * (m & 1) + (e >> 1)
                            acc[m >> 1, 2 * TQ + (e & 1), col] += C[e]
    return acc[0], acc[1]


def emulated(body, x, q4, sl, sh, nblk, ks):
    """y [NW, 8, 2 * N2] of a launch: every (weight, column tile, K slice)
    item scaled by its group's scales, the slices summed in order."""
    nw, d, n2 = q4.shape
    nsub = nblk // COLS
    y = np.zeros((nw, ROWS, 2 * n2), np.float32)
    for w in range(nw):
        for col0 in range(0, n2, nblk):
            cols = slice(col0, col0 + nblk)
            tot_lo = np.zeros((ROWS, nblk), np.float32)
            tot_hi = np.zeros((ROWS, nblk), np.float32)
            for k0 in range(0, d, ks):
                g = k0 // DBLK
                if body == "w4a8":
                    p_lo, p_b, sumx = item_sums_w4a8(q4, x, w, col0, nsub, k0, ks)
                    lo = (p_lo - 8 * sumx[:, None]).astype(np.float32)
                    hi = (p_b - p_lo).astype(np.float32) * np.float32(0.0625)
                else:
                    lo, hi = item_sums_bf16(q4, x, w, col0, nsub, k0, ks, body == "current")
                tot_lo += lo * sl[w, g, cols]
                tot_hi += hi * sh[w, g, cols]
            y[w, :, cols] = tot_lo
            y[w, :, n2 + col0: n2 + col0 + nblk] = tot_hi
    return y


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def test_w4a8_fragment_sums_are_exact(weights):
    """w4a8 work items: the s8 fragments (raw bytes and low nibbles after
    transpose4, x words in stage_x8's K order) give exactly the int32 sums
    x . b and x . (b & 15) of the items' columns; the two 64-row slices of a
    scale group add up to the plain version's group sums exactly."""
    _, q4, _, _, x = weights
    xi = unpack_tool.quantize_rows(torch.from_numpy(x))[0].numpy()
    p_lo, p_b, sumx = item_sums_w4a8(q4, xi, 1, 512, 4, 64, 64)
    qb = q4[1, 64:128, 512:1024].astype(np.int64)
    xk = xi[:, 64:128].astype(np.int64)
    np.testing.assert_array_equal(p_b, xk @ qb)
    np.testing.assert_array_equal(p_lo, xk @ (qb & 15))
    np.testing.assert_array_equal(sumx, xk.sum(-1))
    # group 0 of weight 1, columns 512..1023: slices k0 = 0 and 64
    lo0, b0, _ = item_sums_w4a8(q4, xi, 1, 512, 4, 0, 64)
    _, g_b, g_lo = T._group_products(torch.from_numpy(xi), torch.from_numpy(q4), DBLK,
                                     torch.float64)
    np.testing.assert_array_equal(b0 + p_b, g_b[1, 0, :, 512:1024].numpy())
    np.testing.assert_array_equal(lo0 + p_lo, g_lo[1, 0, :, 512:1024].numpy())


def test_emulated_w4a8_matvec(weights):
    """w4a8 at nblk = 512 and K slices of 64 rows (two per scale group):
    the plain version's exact int32 sums, the Pallas body in interpret
    mode within 1e-6 of scale."""
    _, q4, sl, sh, x = weights
    xi = unpack_tool.quantize_rows(torch.from_numpy(x).to(torch.bfloat16))[0]
    got = emulated("w4a8", xi.numpy(), q4, sl, sh, 512, 64)
    plain = T.int4_unpack_matvec_plain(xi, *(torch.from_numpy(a) for a in (q4, sl, sh)),
                                       body="w4a8", dblk=DBLK).numpy()
    _close(got, plain, 1e-6)
    ref = np.asarray(_unpack_pallas(jnp.asarray(xi.numpy()), jnp.asarray(q4), jnp.asarray(sl),
                                    jnp.asarray(sh), name="w4a8"))
    _close(got[-1], ref, 1e-6)


@pytest.mark.parametrize("body,nblk", [("andtrick", 512), ("andtrick", 128), ("current", 512)])
def test_emulated_bf16_bodies(weights, body, nblk):
    """I at nblk = 512 and 128 (four and one 128-column sub-tiles) and J's
    current on signed-lo bytes, K slices of 64 rows: the plain version within
    1e-5 of scale."""
    _, q4, sl, sh, x = weights
    qb = q4 ^ 8 if body == "current" else q4
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = emulated(body, xb.float().numpy(), qb, sl, sh, nblk, 64)
    args = (xb, *(torch.from_numpy(a) for a in (qb, sl, sh)))
    plain = (T.int4_stream_matvec_plain(*args, dblk=DBLK, nblk=nblk) if body == "andtrick"
             else T.int4_unpack_matvec_plain(*args, body="current", dblk=DBLK))
    _close(got, plain.numpy(), 1e-5)


def test_dma_floor_deswizzle_returns_the_first_rows(weights):
    """dma-floor: byte (r, c) of a work item's first stage read at sub-tile
    c / 128, row r, chunk ((c % 128) / 16) ^ r: the first 8 weight rows, as
    the plain version's lo half."""
    _, q4, sl, sh, x = weights
    plain = T.int4_unpack_matvec_plain(torch.from_numpy(x).to(torch.bfloat16),
                                       *(torch.from_numpy(a) for a in (q4, sl, sh)),
                                       body="dma-floor", dblk=DBLK).numpy()
    nsub = 512 // COLS
    for w in range(NW):
        for col0 in range(0, N2, 512):
            st = np.concatenate(boxes(q4, w, col0, nsub, 0))
            r = np.arange(ROWS)[:, None]
            c = np.arange(nsub * COLS)[None, :]
            b, cc = c // COLS, c % COLS
            got = st[b * KC * COLS + r * COLS + (((cc >> 4) ^ r) << 4) + (cc & 15)]
            np.testing.assert_array_equal(got.view(np.int8).astype(np.float32),
                                          plain[w, :, col0:col0 + 512])
    assert not plain[:, :, N2:].any()


# ---- plans at the tools' shapes ----

TOOL_NW, TOOL_D, TOOL_N2, TOOL_DBLK, SMS = 4, 3072, 8192, 1024, 132
ITEMS = {(2, 512): 384, (3, 512): 192, (4, 512): 192, (4, 256): 384, (6, 256): 384,
         (8, 128): 768}
# The card's answers at the tools' (S, nblk), from which plan() splits K:
# a block's dynamic shared memory (int4_stream_smem) and the blocks an SM
# holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), as chip_smoke.py's
# stream phase printed them on an NVIDIA H100 80GB HBM3 (132 SMs).
CARD = {(2, 512): (83104, 2), (3, 512): (115888, 1), (4, 512): (148672, 1),
        (4, 256): (83136, 2), (6, 256): (115936, 1), (8, 128): (83200, 2)}
SMEM_LIMIT = 232448               # kMaxSmem: dynamic shared memory a block may take
SM_SMEM = 233472                  # an H100 SM's shared memory; 1 KB more per block


def stream_smem(S, nblk):
    """``stream_smem``: alignment slack, S slots of nblk / 128 [64, 128]
    boxes, the bf16 x slice [8][1024 + 8], a full and an empty mbarrier per
    slot."""
    return 1024 + S * KC * nblk + ROWS * (1024 + 8) * 2 + 16 * S


def test_stream_smem_is_the_kernels():
    assert "return kAlign + S * nsub * kSlotBytes + kXBytes + 2 * S * 8;" in STREAM_SRC
    assert f"constexpr int kMaxSmem = {SMEM_LIMIT};" in STREAM_SRC
    assert "__launch_bounds__(kThreads, 2) int4_stream_kernel(" in STREAM_SRC
    # a block too large for the card is 0 blocks per SM, which plan() refuses
    assert stream_smem(8, 512) > SMEM_LIMIT
    assert "*count = 0;" in STREAM_SRC


@pytest.fixture
def card_answers(monkeypatch):
    """plan()'s per-device cache seeded with the card's answers, so that the
    plan runs on CPU tensors."""
    cpu = torch.device("cpu")
    for (S, nblk), (smem, per_sm) in CARD.items():
        for body in ("andtrick",) + (T.UNPACK_BODIES if (S, nblk) == (2, 512) else ()):
            monkeypatch.setitem(T._card, (cpu, body, S, nblk), (SMS, per_sm, smem))
    monkeypatch.setitem(T._card, (cpu, "andtrick", 8, 512), (SMS, 0, stream_smem(8, 512)))
    return torch.zeros((TOOL_NW, TOOL_D, TOOL_N2), dtype=torch.int8)


@pytest.mark.parametrize("S,nblk", T.STREAM_VARIANTS)
def test_stream_variant_plans(S, nblk, card_answers):
    """Every variant fits a block's shared memory, with as many blocks per
    SM as that leaves; kslice divides dblk and is a whole number of 64-row
    stages, so no stage straddles a scale group or (D % 64 == 0) a weight
    of the stack; the work items are the grid chip_smoke.py prints
    (``plan``'s) and fill the card's resident blocks."""
    smem, per_sm = CARD[(S, nblk)]
    assert smem == stream_smem(S, nblk) <= SMEM_LIMIT
    assert per_sm == min(2, SM_SMEM // (smem + 1024)) == (2 if S * nblk <= 1024 else 1)
    p = T.plan(card_answers, "andtrick", S, nblk, TOOL_DBLK)
    assert (p.blocks_per_sm, p.smem) == (per_sm, smem)
    ks, kc = p.kslice, T.KC
    assert TOOL_DBLK % ks == 0 and ks % kc == 0 and TOOL_D % kc == 0 and ks <= T.MAX_SLICE
    for k0 in range(0, TOOL_D, ks):
        for s in range(ks // kc):
            k = k0 + s * kc
            assert k // TOOL_DBLK == (k + kc - 1) // TOOL_DBLK        # one scale group
            assert k // TOOL_D == (k + kc - 1) // TOOL_D              # one weight
    assert p.items == T.work_items(TOOL_NW, TOOL_D, TOOL_N2, nblk, ks)
    assert p.items == TOOL_NW * (TOOL_N2 // nblk) * (TOOL_D // ks) == ITEMS[(S, nblk)]
    assert p.items >= SMS * per_sm
    assert "items=p.items" in CHIP_SMOKE and "p = S.plan(q4, body, Sv, nblk, dblk)" in CHIP_SMOKE
    if (S, nblk) == (2, 512):
        for body in T.UNPACK_BODIES:
            assert T.plan(card_answers, body, S, nblk, TOOL_DBLK) == p


def test_plan_refuses_a_ring_that_does_not_fit(card_answers):
    with pytest.raises(ValueError, match="do not fit"):
        T.plan(card_answers, "andtrick", 8, 512, TOOL_DBLK)
