"""Kernel D's plan and order (``csrc/knn_topk.cu``), on the CPU.

The kernel itself runs only on the card.  What decides its result besides
the distances is its order: the stable compaction of the live slots, the
cut of the work (query tiles x the live points) into one equal range a
block, so that a tile's live points fall into pieces (``knn_pieces``),
each piece's running lists with the group-min gate and strict-less
insertion, chunk by chunk of the ring, and the merge of a tile's pieces in
order.  ``_emulate`` repeats that order in torch over the distances the
plain version computes, so it must equal ``knn_topk_plain`` exactly, ties
and (1e10, -1) tails included; one case is also held against the TPU
kernel in interpret mode.  The plan must cover every (query, live slot)
pair once, with pieces that rise with the id and the same work for every
block.  The decompose tool's patches must still apply to the source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynam3d_tpu.ops.pallas_knn import pallas_knn
from dynam3d_torch.ops import knn as tknn
from dynam3d_torch.tools import decompose_knn as tool

SOURCE = (Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc" / "knn_topk.cu").read_text()
CHUNK, GROUP = 512, 8   # points a ring slot, points a compare covers


def test_constants_are_the_kernels():
    assert re.search(rf"constexpr int kChunk = {CHUNK};", SOURCE)
    assert re.search(rf"constexpr int kGroup = {GROUP};", SOURCE)
    assert re.search(rf"constexpr int kConsumers = {tknn.KNN_THREADS};", SOURCE)
    # the cut knn_pieces mirrors
    assert "long start(long b) const { return b * W / G; }" in SOURCE
    assert "const Cut cut{L, W, W < (long)gridDim.x ? W : (long)gridDim.x};" in SOURCE


def _insert(bd, bi, d, i, rows):
    """The kernel's insert() on the rows ``rows``: (d, i) after every entry
    <= d, the entries behind it shift down."""
    k = bd.shape[1]
    nbd, nbi = bd.clone(), bi.clone()
    for j in range(k - 1, -1, -1):
        lt = rows & (d < bd[:, j])
        shift = lt & (d < bd[:, j - 1]) if j > 0 else torch.zeros_like(lt)
        nbd[:, j] = torch.where(lt, torch.where(shift, bd[:, j - 1], d), bd[:, j])
        nbi[:, j] = torch.where(lt, torch.where(shift, bi[:, j - 1], i), bi[:, j])
    return nbd, nbi


def _scan_piece(d, ids, k):
    """One piece's lists: the ring's chunks in order, groups of eight gated
    by their min, the chunk's ragged tail point by point."""
    nq = d.shape[0]
    bd = torch.full((nq, k), tknn.BIG)
    bi = torch.full((nq, k), -1, dtype=torch.int64)
    everyone = torch.ones(nq, dtype=torch.bool)
    for c0 in range(0, ids.numel(), CHUNK):
        cid = ids[c0:c0 + CHUNK]
        n, j = cid.numel(), 0
        while j + GROUP <= n:
            gd = d[:, cid[j:j + GROUP]]
            hit = gd.min(dim=1).values < bd[:, -1]      # the group-min gate
            if bool(hit.any()):
                for g in range(GROUP):
                    bd, bi = _insert(bd, bi, gd[:, g], cid[j + g], hit & (gd[:, g] < bd[:, -1]))
            j += GROUP
        for t in range(j, n):
            bd, bi = _insert(bd, bi, d[:, cid[t]], cid[t], everyone)
    return bd, bi


def _emulate(q, pts, valid, k, plan):
    """Kernel D's order over the plain version's distances."""
    d_all = tknn.pairwise_sq_dists(q, pts)
    nq = q.shape[0]
    live_ids = torch.nonzero(valid).flatten()          # stable compaction
    pieces = tknn.knn_pieces(plan, live_ids.numel())
    out_d = torch.full((nq, k), tknn.BIG)
    out_i = torch.full((nq, k), -1, dtype=torch.int64)
    for t, tile_pieces in enumerate(pieces):
        rows = slice(t * plan.tile_q, min(nq, (t + 1) * plan.tile_q))
        lists = [_scan_piece(d_all[rows], live_ids[p0:p1], k) for _, p0, p1 in tile_pieces]
        if not lists:
            continue
        bd, bi = lists[0]                               # the merge, in piece order
        everyone = torch.ones(bd.shape[0], dtype=torch.bool)
        for sd, si in lists[1:]:
            for j in range(k):
                bd, bi = _insert(bd, bi, sd[:, j], si[:, j], everyone)
        out_d[rows] = torch.where(bi >= 0, bd, torch.full_like(bd, tknn.BIG))
        out_i[rows] = bi
    return out_d, out_i


def _case(name, k, rng):
    """(queries, points, valid, grid) of one hard case; r = 2, so 256
    queries a tile."""
    if name == "duplicates":
        # three copies of 160 grid positions, copy c at slots c*160 ..: two
        # tiles on six blocks cut each tile's table into its three copies,
        # so every tie crosses a piece boundary
        g = np.stack(np.meshgrid(np.arange(8), np.arange(5), np.arange(4), indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
        pts = np.concatenate([g, g, g])
        valid = np.ones(pts.shape[0], bool)
        q = g[rng.integers(0, g.shape[0], 301)] + rng.uniform(-0.6, 0.6, (301, 3))
        return q.astype(np.float32), pts, valid, 6
    pts = rng.uniform(-3, 3, (1100, 3)).astype(np.float32)
    q = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    if name == "dead_split":
        # a dead range as long as a piece, and dead slots around it: dead
        # slots are never staged, so no piece is cut where they lie
        valid = rng.uniform(size=1100) > 0.3
        valid[367:733] = False
        return q, pts, valid, 5
    if name == "few_live":
        # fewer than k live points, one or two a piece (none for k = 1):
        # the (1e10, -1) tail survives the merge
        valid = np.zeros(1100, bool)
        valid[[40, 200, 380, 500, 700, 900, 1090][:k - 1]] = True
        return q, pts, valid, 8
    # ragged: Q and P multiples of neither a tile, a ring slot nor a group,
    # pieces that span chunk boundaries
    pts = rng.uniform(-3, 3, (1303, 3)).astype(np.float32)
    valid = rng.uniform(size=1303) > 0.2
    return rng.uniform(-3, 3, (517, 3)).astype(np.float32), pts, valid, 5


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("name", ["duplicates", "dead_split", "few_live", "ragged"])
def test_emulated_order_equals_plain(name, k):
    rng = np.random.default_rng(17 + k)
    q, pts, valid, grid = _case(name, k, rng)
    q, pts, valid = torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(valid)
    plan = tknn.knn_plan(q.shape[0], k, 1, r=2, grid=grid)
    n_live = int(valid.sum())
    assert max(len(p) for p in tknn.knn_pieces(plan, n_live)) >= min(3, n_live)
    ed, ei = _emulate(q, pts, valid, k, plan)
    pd, pi = tknn.knn_topk_plain(q, pts, valid, k)
    assert torch.equal(ei, pi)
    assert torch.equal(ed, pd)
    if name == "duplicates" and k > 1:
        # equal distances at different ids do occur, each kept by the smaller id
        tie = (pd[:, 1:] == pd[:, :-1]) & (pi[:, 1:] >= 0)
        assert bool(tie.any()) and bool((pi[:, 1:][tie] > pi[:, :-1][tie]).all())
    if name == "few_live":
        assert bool((pi[:, k - 1:] == -1).all()) and bool((pd[:, k - 1:] == tknn.BIG).all())


def test_emulated_order_matches_pallas_knn():
    """The TPU kernel in interpret mode at Q=300, P=1100 (dead slots and a
    dead 256-point chunk), against the emulation with two tiles on five
    blocks."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3, 3, (1100, 3)).astype(np.float32)
    valid = rng.uniform(size=1100) > 0.2
    valid[256:512] = False
    q = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    jd, ji = pallas_knn(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(valid), 4,
                        tile_q=128, chunk=256, interpret=True)
    plan = tknn.knn_plan(300, 4, 1, r=2, grid=5)
    ed, ei = _emulate(torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(valid), 4,
                      plan)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ed.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,np_,k,sms,live_frac", [
    (72144, 32768, 4, 132, 0.6152),   # render stage 1 (20,160 live of 32,768)
    (10007, 32768, 1, 132, 0.4),
    (3001, 6144, 8, 132, 1.0),
    (517, 1303, 4, 132, 0.8),
    (300, 1100, 8, 8, 0.005),
    (1, 5, 2, 8, 0.0),
])
def test_plan_covers_every_pair_once(nq, np_, k, sms, live_frac):
    rng = np.random.default_rng(nq)
    valid = rng.uniform(size=np_) < live_frac
    live_ids = np.nonzero(valid)[0]
    L = live_ids.size
    rs = (2, 4, 8) if k == 4 else (2,)
    for plan in [tknn.knn_plan(nq, k, sms, blocks_per_sm=5)] + [
            tknn.knn_plan(nq, k, sms, r=r, grid=g) for r in rs for g in (1, 7, sms * 3)]:
        assert plan.tiles * plan.tile_q >= nq > (plan.tiles - 1) * plan.tile_q
        # an item's pairs are its tile's queries x its piece's live slots:
        # the tiles cut the queries once, each tile's pieces its live slots
        queries = np.zeros(nq, np.int32)
        for t in range(plan.tiles):
            queries[t * plan.tile_q:(t + 1) * plan.tile_q] += 1
        assert (queries == 1).all()
        pieces = tknn.knn_pieces(plan, L)
        work = {}
        for tile_pieces in pieces:
            slots = np.zeros(np_, np.int32)
            end = 0
            for b, p0, p1 in tile_pieces:
                assert p0 == end < p1                 # in order, no gap, none empty
                end = p1
                slots[live_ids[p0:p1]] += 1           # rising ids: live_ids is sorted
                work[b] = work.get(b, 0) + p1 - p0
            assert end == L or not tile_pieces and L == 0
            assert (slots[valid] == 1).all() and (slots[~valid] == 0).all()
        if L:
            # every block that runs gets the same work, to one point
            assert len(work) == min(plan.grid, plan.tiles * L)
            assert max(work.values()) - min(work.values()) <= 1
            # a block cuts at most two tiles (its first and last piece: the
            # kernel's two partial slots a block)
            cut = {}
            for tile_pieces in pieces:
                if len(tile_pieces) > 1:
                    for b, _, _ in tile_pieces:
                        cut[b] = cut.get(b, 0) + 1
            assert max(cut.values(), default=0) <= 2


def test_plan_fills_the_card():
    """Stage 1 on 132 SMs holding five blocks each: 282 tiles of 256
    queries, one wave of 660 blocks, three or four pieces a tile."""
    p = tknn.knn_plan(72144, 4, 132, blocks_per_sm=5)
    assert (p.r, p.tile_q, p.tiles, p.grid) == (2, 256, 282, 660)
    assert {len(x) for x in tknn.knn_pieces(p, 20160)} == {3, 4}


@pytest.mark.parametrize("variant", sorted(tool.PATCHES))
def test_decompose_patches_apply_to_the_source(variant):
    assert tool.design(tool.PACKAGE) == "live"
    for source, old, _ in tool.PATCHES[variant]:
        assert source == "knn_topk.cu" and SOURCE.count(old) == 1, variant


def test_decompose_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "_copy", lambda *a, **k: pytest.fail("copied without a card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the launch path raises on a CPU tensor before it looks
    for the kernel library; ``knn_topk`` takes the plain version there."""
    q, pts = torch.zeros(4, 3), torch.zeros(8, 3)
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_topk_cuda(q, pts, valid, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_launch(q, pts, valid, 2, tknn.knn_plan(4, 2, 1))
