"""The attention body of kernels B and H (``csrc/decode_attn.cuh``) emulated
on the CPU, since the kernel itself runs only on the card.

Two levels:

- the plan and the merge, in torch: each (head, cache group) scan cut into
  sequence splits of 64-row tiles (``attn_splits``), each split's tiles
  taken 16 rows per consumer warp with an online softmax whose P enters the
  context product as bf16 hi + lo parts, the four warps merged in warp
  order, the splits merged in split order, the in-flight rows folded last;
  held against ``ops/decode.py::_attn_math`` in the three modes, with mask
  holes, t_scan not a multiple of 64, a split whose rows are all masked, and
  head dims 64 and 96;
- the lane maps, in numpy: the TMA's 64-byte swizzled tile, the ldmatrix
  addresses of K (B operand of S = Q K^T) and V (``ldmatrix.trans``, B
  operand of P V), S's C fragment reused as P's A fragment, and the
  m16n8k16 fragments of the PTX ISA, as ``test_torch_int4_fragments.py``
  emulates kernel A's.

Tolerance of the emulated merge against ``_attn_math``: both are f32 with
bf16 q / k / v; only the summation order and the P hi/lo split (relative
error ~2^-17) differ, so the bf16 outputs are at most one bf16 step apart:
rtol 2^-7.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dynam3d_torch.ops import decode as T
from dynam3d_torch.tools import decompose_decode_attn as tool

CSRC = Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc"
HEADER = (CSRC / "decode_attn.cuh").read_text()
TILE, WARPS, BOX_COLS, BOX_BYTES = 64, 4, 32, 64 * 32 * 2
NEG = -math.inf


def test_constants_are_the_kernels():
    for name, v in (("kTile", TILE), ("kBoxCols", BOX_COLS), ("kWarps", WARPS),
                    ("kMaxRows", T.MAX_ROWS), ("kMaxSplits", T.MAX_SPLITS), ("kStages", 2)):
        assert re.search(rf"constexpr int {name} = {v};", HEADER), name
    assert T.TILE == TILE
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in HEADER
    assert not (CSRC / "int4_tile.cuh").exists()
    for src in ("decode_attn.cu", "decode_attn_layer.cu"):
        assert '#include "decode_attn.cuh"' in (CSRC / src).read_text()
    assert '#include "int4_mma.cuh"' in (CSRC / "decode_attn_layer.cu").read_text()


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("slots,pairs,t_scan", [
    (264, 32, 1024), (264, 64, 1024), (264, 32, 869), (264, 32, 0), (264, 2, 40),
    (264, 32, 64), (264, 256, 1024), (396, 32, 4096), (1, 1, 65), (264, 1, 4096)])
def test_splits_cover_the_scan(slots, pairs, t_scan):
    """Every tile in exactly one split, no split empty (but the one split of
    an empty scan), at most MAX_SPLITS, and as many items as fit the slots
    where the tiles allow."""
    nsplit, tps = T.attn_splits(slots, pairs, t_scan)
    tiles = -(-t_scan // TILE)
    assert 1 <= nsplit <= T.MAX_SPLITS
    if tiles == 0:
        assert (nsplit, tps) == (1, 0)
        return
    assert nsplit * tps >= tiles > (nsplit - 1) * tps
    want = min(max(1, slots // pairs), tiles, T.MAX_SPLITS)
    assert nsplit <= want and -(-tiles // want) == tps
    assert pairs * nsplit <= max(slots, pairs)


# The card's answers at head dim 96, as chip_smoke.py's ring phase printed
# them (decode_attn_occupancy) on an NVIDIA H100 80GB HBM3: 132 SMs, 1
# block of the kernel per SM.
SMS, PER_SM = 132, 1


@pytest.fixture
def card(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(T, "_attn_plans", {})
    monkeypatch.setitem(T._attn_card, (cpu, 96), (SMS, PER_SM))
    return cpu


@pytest.mark.parametrize("mode,B,group,nsplit,tps", [
    ("plain", 1, 1, 4, 4), ("shared_cache", 8, 8, 4, 4), ("group_size", 4, 2, 2, 8)])
def test_plan_at_the_ring_shapes(card, mode, B, group, nsplit, tps):
    """Phi-3-mini (32 heads of 96) at t_scan 1024: at most a work item per
    SM, every item resident at once (under one wave of the card's blocks)."""
    p = T.attn_plan(card, 96, 32, B // group, 1024)
    items = 32 * (B // group) * nsplit
    assert (p.nsplit, p.tps, p.items, p.sms, p.blocks_per_sm) == (nsplit, tps, items, SMS, PER_SM)
    assert p.nsplit * p.tps >= 16 > (p.nsplit - 1) * p.tps
    assert items <= SMS and p.waves == items / (SMS * PER_SM)
    assert T.attn_plan(card, 96, 32, B // group, 1024) is p   # cached


def test_kernel_h_splits_at_its_grid():
    """Kernel H's phase 2 at its cooperative grid (2 blocks x 132 SMs):
    one item per block."""
    nsplit, tps = T.attn_splits(2 * SMS, 32, 1024)
    assert (nsplit, tps) == (8, 2) and 32 * nsplit <= 2 * SMS


def _smem_bytes(hd, rows):
    """``Layout<HD, R>::kBytes``: two ring slots of K and V, four barriers,
    q bf16, in-flight k / v, per-warp m / l / factor and acc, split factors,
    fold score / alpha / p, row sums and a flag."""
    return (2 * 2 * hd * TILE * 2 + 32 + rows * hd * 2 + 2 * rows * hd * 4
            + 3 * WARPS * rows * 4 + WARPS * rows * hd * 4 + T.MAX_SPLITS * rows * 4
            + 3 * rows * rows * 4 + rows * 4 + 16)


def test_shared_memory_leaves_the_card_its_blocks():
    """Kernel B at hd 96 would fit three blocks' shared memory on an SM; its
    one block per SM is set by its launch bounds (registers), which the
    plan's one item per SM matches.  Kernel H fits two (its int4 ring and x
    slice beside the attention region): its cooperative grid of 264
    blocks.  An H100 SM has 233472 bytes, 1 KB reserved per block."""
    sm = 233472
    b96 = 1024 + _smem_bytes(96, T.MAX_ROWS)
    assert sm // (b96 + 1024) == 3
    kernel_b = (CSRC / "decode_attn.cu").read_text()
    assert "__launch_bounds__(da::kThreads, 1) decode_attn_kernel(" in kernel_b
    int4_region = -(-(32768 + 8 * 1032 * 2 + 64) // 1024) * 1024
    h96 = 1024 + int4_region + _smem_bytes(96, 1)
    assert sm // (h96 + 1024) == 2
    assert "static constexpr int kBytes = kFlag + 16;" in HEADER


# ------------------------------------------------- the body, emulated in torch

def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _rope(t, c, s):
    half = t.shape[-1] // 2
    t1, t2 = t[..., :half], t[..., half:]
    return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], -1)


def _merge(ms, ls, accs):
    """States merged in list order: (m, l, acc) with every exp taken against
    a finite maximum (-inf rows merge as zeros)."""
    M = torch.stack(ms).max(0).values
    mu = torch.where(M == NEG, torch.zeros_like(M), M)
    L = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        f = torch.exp(m - mu)
        L = L + f * l
        A = A + f[:, None] * acc
    return M, L, A


def _split_state(q, kc, vc, live, t0, t1, scale, p_lo=True):
    """One work item: tiles t0..t1-1 of the scan, 16 rows per warp, online
    softmax per warp, P as bf16 hi (+ lo), the warps merged in order."""
    n, hd = q.shape
    ms, ls, accs = [], [], []
    for w in range(WARPS):
        m = torch.full((n,), NEG)
        l = torch.zeros(n)
        acc = torch.zeros(n, hd)
        for tile in range(t0, t1):
            r0 = tile * TILE + 16 * w
            x = torch.where(live[:, r0:r0 + 16], (q @ kc[r0:r0 + 16].T) * scale,
                            torch.full((n, 16), NEG))
            mn = torch.maximum(m, x.max(1).values)
            mu = torch.where(mn == NEG, torch.zeros_like(mn), mn)
            alpha = torch.exp(m - mu)
            p = torch.exp(x - mu[:, None])
            l = l * alpha + p.sum(1)
            m = mn
            ph = _bf(p)
            acc = acc * alpha[:, None] + ph @ vc[r0:r0 + 16]
            if p_lo:
                acc = acc + _bf(p - ph) @ vc[r0:r0 + 16]
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    return _merge(ms, ls, accs)


def emulate(qkv, cos, sin, cache_k, cache_v, li, mask, t_scan, group, heads, hd, nsplit, tps,
            p_lo=True):
    """Kernel B's result from the body's steps: ``(ctx, k_new, v_new)`` bf16."""
    B = qkv.shape[0]
    D = heads * hd
    y = qkv.view(B, 3, heads, hd)
    cos2, sin2 = cos.reshape(-1, hd // 2).expand(B, -1), sin.reshape(-1, hd // 2).expand(B, -1)
    mask2 = mask.reshape(-1, mask.shape[-1]).expand(B, -1)
    q = _bf(_rope(y[:, 0], cos2[:, None], sin2[:, None]))
    kr = _rope(y[:, 1], cos2[:, None], sin2[:, None])
    kf, vf = _bf(kr), _bf(y[:, 2])
    scale = 1.0 / math.sqrt(hd)
    ntiles = -(-t_scan // TILE)
    rows_cov = max(1, ntiles) * TILE
    ctx = torch.zeros(B, heads, hd)
    for c in range(B // group):
        rows = slice(c * group, (c + 1) * group)
        live = torch.zeros(group, rows_cov, dtype=torch.bool)
        live[:, :t_scan] = mask2[rows, :t_scan]
        for h in range(heads):
            # the tensor map's rows past t_scan land as zeros
            kc = torch.zeros(rows_cov, hd)
            vc = torch.zeros(rows_cov, hd)
            kc[:t_scan] = cache_k[li, c, :t_scan, h * hd:(h + 1) * hd].float()
            vc[:t_scan] = cache_v[li, c, :t_scan, h * hd:(h + 1) * hd].float()
            parts = [_split_state(q[rows, h], kc, vc, live, min(s * tps, ntiles),
                                  min(s * tps + tps, ntiles), scale, p_lo)
                     for s in range(nsplit)]
            M, L, A = _merge(*zip(*parts))
            for r in range(group):
                j0 = c * group
                Mr, Lr, a = M[r], L[r], A[r]
                for j in range(j0, j0 + r + 1):
                    sf = (q[j0 + r, h] * kf[j, h]).sum() * scale
                    mn = torch.maximum(Mr, sf)
                    al, pf = torch.exp(Mr - mn), torch.exp(sf - mn)
                    Lr = Lr * al + pf
                    a = a * al + pf * vf[j, h]
                    Mr = mn
                ctx[j0 + r, h] = a / torch.clamp(Lr, min=1e-30)
    return (ctx.reshape(B, D).to(torch.bfloat16), kr.reshape(B, D).to(torch.bfloat16),
            y[:, 2].reshape(B, D).to(torch.bfloat16))


def _case(B, group, hd, t_scan, holes, heads=2, tmax=512, seed=0):
    rng = np.random.default_rng(seed)
    D = heads * hd
    n_cache = B // group
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    qkv = t(B, 3 * D) * 2.0
    ck = t(1, n_cache, tmax, D).to(torch.bfloat16)
    cv = t(1, n_cache, tmax, D).to(torch.bfloat16)
    ang = torch.from_numpy(rng.uniform(0, 6, (B, hd // 2)).astype(np.float32))
    idx = torch.arange(tmax)
    mask = torch.stack([(idx < t_scan - (r % 3)) for r in range(B)])
    for a, b in holes:
        mask[:, a:b] = False
    return qkv, torch.cos(ang), torch.sin(ang), ck, cv, 0, mask, t_scan, group, heads, hd


CASES = {
    "plain": (2, 1), "grouped": (4, 2), "shared": (8, 8),
}


@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("mode", sorted(CASES))
def test_emulated_body_matches_attn_math(mode, hd):
    """Holes, t_scan 333 (not a multiple of 64) over 3 splits of 2 tiles."""
    B, group = CASES[mode]
    args = _case(B, group, hd, 333, holes=[(10, 30), (100, 101)], seed=hd)
    nsplit, tps = T.attn_splits(3 * args[-2] * (B // group), args[-2] * (B // group), 333)
    assert (nsplit, tps) == (3, 2)
    ref = T._attn_math(*args)
    got = emulate(*args, nsplit=nsplit, tps=tps)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("mode", sorted(CASES))
def test_a_split_with_every_row_masked_merges_without_nan(mode):
    """Tiles 1 and 2 (rows 64..191) fully masked: the split holding them has
    m = -inf and l = 0 and adds nothing; one split per tile."""
    B, group = CASES[mode]
    args = _case(B, group, 64, 300, holes=[(64, 192)], seed=3)
    got = emulate(*args, nsplit=5, tps=1)
    ref = T._attn_math(*args)
    assert all(bool(torch.isfinite(a.float()).all()) for a in got)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=1e-5)


def test_empty_scan_folds_only_the_in_flight_rows():
    args = _case(4, 4, 64, 0, holes=[], seed=5)
    nsplit, tps = T.attn_splits(264, 2, 0)
    got = emulate(*args, nsplit=nsplit, tps=tps)
    for a, b in zip(got, T._attn_math(*args)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=1e-5)


def test_p_lo_part_keeps_f32_fidelity():
    """P rounded to bf16 alone (the TPU's rounding) moves ctx by far more
    than the hi + lo split does; the split keeps the f32 result."""
    args = _case(8, 8, 96, 450, holes=[(7, 9)], seed=11, heads=1)
    q_args = dict(nsplit=2, tps=4)
    exact = _exact_ctx(*args)
    hilo = _f32_ctx(args, p_lo=True, **q_args)
    hi = _f32_ctx(args, p_lo=False, **q_args)
    err_hilo = (hilo - exact).abs().max().item()
    err_hi = (hi - exact).abs().max().item()
    assert err_hilo < 2e-6 and err_hi > 20 * err_hilo


def _f32_ctx(args, p_lo, nsplit, tps):
    """The emulated body's ctx before its bf16 rounding (one cache group)."""
    qkv, cos, sin, ck, cv, li, mask, t_scan, group, heads, hd = args
    y = qkv.view(qkv.shape[0], 3, heads, hd)
    q = _bf(_rope(y[:, 0, 0], cos, sin))
    ntiles = -(-t_scan // TILE)
    kc = torch.zeros(ntiles * TILE, hd)
    vc = torch.zeros(ntiles * TILE, hd)
    kc[:t_scan], vc[:t_scan] = ck[li, 0, :t_scan].float(), cv[li, 0, :t_scan].float()
    live = torch.zeros(group, ntiles * TILE, dtype=torch.bool)
    live[:, :t_scan] = mask[:, :t_scan]
    parts = [_split_state(q, kc, vc, live, s * tps, min(s * tps + tps, ntiles),
                          1.0 / math.sqrt(hd), p_lo) for s in range(nsplit)]
    _, L, A = _merge(*zip(*parts))
    return A / L[:, None]


def _exact_ctx(qkv, cos, sin, ck, cv, li, mask, t_scan, group, heads, hd):
    y = qkv.view(qkv.shape[0], 3, heads, hd).double()
    q = _rope(y[:, 0, 0].float(), cos, sin).to(torch.bfloat16).double()
    kc, vc = ck[li, 0, :t_scan].double(), cv[li, 0, :t_scan].double()
    x = (q @ kc.T) / math.sqrt(hd)
    x = x.masked_fill(~mask[:, :t_scan], NEG)
    return (torch.softmax(x, 1) @ vc).float()


# ------------------------------------------------------- the lane maps, numpy

LANES = np.arange(32)
G, TQ = LANES >> 2, LANES & 3


def swz(r, c):
    """``swz`` in decode_attn.cuh: byte offset of (row r, column c), c % 8 ==
    0, in a tile of hd / 32 TMA boxes of [64, 32] bf16 under the 64-byte
    swizzle (16-byte chunk j of row r at j ^ ((r / 2) % 4))."""
    return (c >> 5) * BOX_BYTES + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4)


def test_lane_formulas_are_the_kernels():
    for text in ("return (c >> 5) * kBoxBytes + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4);",
                 "ldsm_x4(kb, kt + swz(16 * warp + 8 * (lane >> 4) + (lane & 7),",
                 "16 * kk + 8 * ((lane >> 3) & 1)));",
                 "ldsm_x4_trans(vb, vt + swz(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),",
                 "16 * n2 + 8 * (lane >> 4)));",
                 "const uint32_t qf[4] = {qa[kk][0], 0u, qa[kk][1], 0u};",
                 "split_p(p[0], p[1], ph[0], pl[0]);", "split_p(p[2], p[3], ph[2], pl[2]);",
                 "mma(acc[2 * n2], ph, vb[0], vb[1]);", "mma(acc[2 * n2 + 1], pl, vb[2], vb[3]);",
                 "mma(sc[kk & 1][0], qf, kb[0], kb[1]);", "mma(sc[kk & 1][1], qf, kb[2], kb[3]);"):
        assert text in HEADER, text


def tma_tile(tile):
    """A [64, hd] bf16 tile as the TMA lays its boxes out: uint16 words at
    byte offset / 2."""
    rows, hd = tile.shape
    out = np.zeros(hd * rows, np.uint16)
    bits = tile.astype(np.float32).view(np.uint32) >> 16
    for r in range(rows):
        for c in range(0, hd, 8):
            off = swz(r, c) // 2
            out[off:off + 8] = bits[r, c:c + 8]
    return out


def ldmatrix(smem, addr, trans=False):
    """ldmatrix.x4: lanes 8q..8q+7 address the rows of matrix q; thread i
    gets (row i / 4, columns 2(i % 4), +1) of each, or with .trans (rows
    2(i % 4), +1, column i / 4).  -> [4 registers][lane][2 halves] floats."""
    regs = np.zeros((4, 32, 2), np.float32)
    for q in range(4):
        mat = np.stack([smem[addr[8 * q + i] // 2: addr[8 * q + i] // 2 + 8] for i in range(8)])
        f = (mat.astype(np.uint32) << 16).view(np.float32)
        for i in range(32):
            if trans:
                regs[q, i] = f[2 * (i % 4), i // 4], f[2 * (i % 4) + 1, i // 4]
            else:
                regs[q, i] = f[i // 4, 2 * (i % 4)], f[i // 4, 2 * (i % 4) + 1]
    return regs


def a_matrix(a0, a1, a2, a3):
    """PTX m16n8k16 A (16 x 16): a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g,
    2t+8..), a3 = (g+8, 2t+8..); each [lane][2]."""
    A = np.zeros((16, 16), np.float32)
    for reg, (dm, dk) in zip((a0, a1, a2, a3), ((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in range(2):
            A[G + dm, 2 * TQ + dk + h] = reg[:, h]
    return A


def b_matrix(b0, b1):
    """PTX B (16 x 8, K x N): b0 = (2t..2t+1, g), b1 = (2t+8.., g)."""
    B = np.zeros((16, 8), np.float32)
    for reg, dk in ((b0, 0), (b1, 8)):
        for h in range(2):
            B[2 * TQ + dk + h, G] = reg[:, h]
    return B


def c_regs(Dm):
    """PTX C (16 x 8): c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t), c3 =
    (g+8, 2t+1) -> [4][lane]."""
    return np.stack([Dm[G, 2 * TQ], Dm[G, 2 * TQ + 1], Dm[G + 8, 2 * TQ], Dm[G + 8, 2 * TQ + 1]])


def bf16(x):
    return (np.asarray(x, np.float32).view(np.uint32) + 0x7FFF
            + ((np.asarray(x, np.float32).view(np.uint32) >> 16) & 1) >> 16 << 16).view(np.float32)


def test_bf16_rounds_to_nearest_even():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(bf16(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("warp", [0, 3])
def test_warp_tile_lane_by_lane(hd, warp):
    """One warp's 16 rows of a tile: S = Q K^T from q's A fragments and K's
    ldmatrix B fragments, then P V with S's C fragment as P's A fragment (hi
    and lo) and V's ldmatrix.trans B fragments; against the dense products.
    Rows g >= 5 of q are padding (5 query rows)."""
    rng = np.random.default_rng(hd + warp)
    nq = 5
    q = bf16(rng.standard_normal((16, hd)))
    q[nq:] = 0
    k = bf16(rng.standard_normal((TILE, hd)))
    v = bf16(rng.standard_normal((TILE, hd)))
    ks, vs = tma_tile(k), tma_tile(v)
    lane = LANES
    sc = np.zeros((2, 4, 32), np.float32)
    for kk in range(hd // 16):
        kb = ldmatrix(ks, swz(16 * warp + 8 * (lane >> 4) + (lane & 7),
                              16 * kk + 8 * ((lane >> 3) & 1)))
        qa0 = np.stack([q[G, 16 * kk + 2 * TQ], q[G, 16 * kk + 2 * TQ + 1]], -1)
        qa2 = np.stack([q[G, 16 * kk + 8 + 2 * TQ], q[G, 16 * kk + 9 + 2 * TQ]], -1)
        A = a_matrix(qa0, np.zeros_like(qa0), qa2, np.zeros_like(qa2))
        for j in range(2):
            sc[j] += c_regs(A @ b_matrix(kb[2 * j], kb[2 * j + 1]))
    rows = slice(16 * warp, 16 * warp + 16)
    s_ref = q @ k[rows].T                                         # [16 q, 16 cache]
    for j in range(2):
        np.testing.assert_allclose(c_regs(s_ref[:, 8 * j:8 * j + 8]),
                                   sc[j], rtol=1e-5, atol=1e-4)
    # P from the C fragment (real rows g only; c2, c3 are the padding rows)
    p = np.exp(np.stack([sc[0][0], sc[0][1], sc[1][0], sc[1][1]]) / 8.0 - 2.0)   # [4][lane]
    ph = bf16(p)
    pl = bf16(p - ph)
    acc = np.zeros((hd // 8, 4, 32), np.float32)
    for n2 in range(hd // 16):
        vb = ldmatrix(vs, swz(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),
                              16 * n2 + 8 * (lane >> 4)), trans=True)
        for part in (ph, pl):
            A = a_matrix(np.stack([part[0], part[1]], -1), np.zeros((32, 2)),
                         np.stack([part[2], part[3]], -1), np.zeros((32, 2)))
            acc[2 * n2] += c_regs(A @ b_matrix(vb[0], vb[1]))
            acc[2 * n2 + 1] += c_regs(A @ b_matrix(vb[2], vb[3]))
    # P as a dense [16 q, 16 cache] matrix: lane (g, t) holds columns 2t, 2t+1, 8+2t, 9+2t of row g
    P = np.zeros((16, 16), np.float32)
    for i, col in enumerate((2 * TQ, 2 * TQ + 1, 8 + 2 * TQ, 9 + 2 * TQ)):
        P[G, col] = p[i]
    ctx_ref = P.astype(np.float64) @ v[rows].astype(np.float64)
    for n in range(hd // 8):
        got = np.stack([acc[n][0], acc[n][1]])                    # row g, columns 8n + 2t, +1
        want = np.stack([ctx_ref[G, 8 * n + 2 * TQ], ctx_ref[G, 8 * n + 2 * TQ + 1]])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not acc[n][2:].any()                               # padding rows stay zero


@pytest.mark.parametrize("trans_rows", [False, True])
def test_ldmatrix_rows_fall_on_distinct_banks(trans_rows):
    """Each 8-lane phase of both ldmatrix.x4 reads eight 16-byte rows that
    cover all 32 banks once, for every warp, k step and column pair."""
    lane = LANES
    for warp in range(WARPS):
        for step in range(128 // 16):
            if trans_rows:
                addr = swz(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),
                           16 * step + 8 * (lane >> 4))
            else:
                addr = swz(16 * warp + 8 * (lane >> 4) + (lane & 7),
                           16 * step + 8 * ((lane >> 3) & 1))
            for q in range(4):
                banks = ((addr[8 * q:8 * q + 8, None] + 4 * np.arange(4)) // 4) % 32
                assert sorted(banks.ravel()) == list(range(32))


# ------------------------------------------------------------- the tool's patches

@pytest.mark.parametrize("variant", sorted(tool.PATCHES["split"]))
def test_decompose_patches_apply_to_the_sources(variant):
    assert tool.design(tool.PACKAGE) == "split"
    for source, old, _ in tool.PATCHES["split"][variant]:
        assert old in (CSRC / source).read_text(), (variant, source)


def test_decompose_raises_without_a_card(monkeypatch):
    """The tool times the card: without one it raises before copying or
    building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "_copy", lambda *a, **k: pytest.fail("copied without a card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])
