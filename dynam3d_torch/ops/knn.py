"""Masked k-nearest neighbours over fixed-capacity tables, and kernel D.

Port of ``ops/knn.py`` (``knn_brute``, ``knn_tiled``, ``knn_banded``,
``radius_mask_fill``, ``morton_codes``, ``morton_perm``) and of
``ops/pallas_knn.py`` (``pallas_knn`` as kernel D, ``knn_auto``).  Squared
distances use the ``|q|^2 + |p|^2 - 2 q.p`` expansion in full float32, dead
slots sit at distance 1e10.

Two orders of ties:

* :func:`knn_brute` sorts every slot, dead ones included: ties keep the
  smaller id and dead slots surface with their own ids at 1e10.
* :func:`knn_tiled`, :func:`knn_topk` and :func:`knn_banded` keep a
  running best list that starts at ``(1e10, -1)`` and takes a point only
  when it is strictly closer: ties keep the smaller id, and while fewer than
  ``k`` live points are found the tail stays ``(1e10, -1)``.  (The TPU
  kernel keeps that tail only within its first 2048-point chunk; past it,
  its merge can repeat earlier ids at 1e10.  The renderer reads only the
  distances of such rows.)
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from dynam3d_torch import flags
from dynam3d_torch.ops import kernels
from dynam3d_torch.ops.int4 import _ticket_buffer

BIG = 1e10
MAX_K = 8
_TILE_GROUP = 8       # near tiles a band scans per distance block (bounds its memory)


def pairwise_sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    q2 = (queries * queries).sum(dim=-1, keepdim=True)
    p2 = (points * points).sum(dim=-1, keepdim=True).T
    cross = queries @ points.T          # full fp32: TF32 is pinned off on the card
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def knn_brute(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sq_dists [Q, k], indices [Q, k])`` ascending; ties keep the
    smaller index (a stable sort), dead slots surface as >= 1e10."""
    d = pairwise_sq_dists(queries.to(torch.float32), points.to(torch.float32))
    d = torch.where(valid[None, :], d, torch.full_like(d, BIG))
    dist, idx = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


def radius_mask_fill(sq_dists: torch.Tensor, indices: torch.Tensor, radius: float,
                     clamp_dist: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean distances, with index -1 at or beyond ``radius`` (and the
    distance clamped to ``radius`` there when ``clamp_dist``)."""
    d = torch.sqrt(sq_dists)
    out_of_range = d >= radius
    idx = torch.where(out_of_range, torch.full_like(indices, -1), indices)
    if clamp_dist:
        d = torch.where(out_of_range, torch.full_like(d, radius), d)
    return d, idx


# ---------------------------------------------------------------------------
# running-best k-NN (the contract of knn_tiled and of kernel D)

def _masked_dists(queries, points, valid) -> torch.Tensor:
    d = pairwise_sq_dists(queries, points)
    return torch.where(valid[None, :], d, torch.full_like(d, BIG))


def _merge_best(bd: torch.Tensor, bi: torch.Tensor, d: torch.Tensor, ids: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a running best list ``(bd, bi) [Q, k]`` with a block of
    candidates ``d [Q, n]`` (ids ``[n]``): the ``k`` smallest ``(distance,
    id)`` pairs below 1e10, in that order, with a ``(1e10, -1)`` tail.

    Distances are >= 0, so their float32 bits order like the values; with
    the id in the low 32 bits every key is unique and ``topk`` has no ties
    to break."""
    key_best = (bd.view(torch.int32).to(torch.int64) << 32) | bi.clamp(min=0)
    dc = torch.clamp(d, max=BIG)
    key_new = (dc.view(torch.int32).to(torch.int64) << 32) | ids.to(torch.int64)[None, :]
    key = torch.topk(torch.cat([key_best, key_new], 1), k, dim=1, largest=False,
                     sorted=True).values
    dist = (key >> 32).to(torch.int32).view(torch.float32)
    hit = dist < BIG
    return (torch.where(hit, dist, torch.full_like(dist, BIG)),
            torch.where(hit, key & 0xFFFFFFFF, torch.full_like(key, -1)))


def _empty_best(q: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((q, k), BIG, dtype=torch.float32, device=device),
            torch.full((q, k), -1, dtype=torch.int64, device=device))


def knn_tiled(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor, k: int,
              q_chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN for large tables, ``q_chunk`` queries at a time (the
    reference's running top-k over point tiles has the same result)."""
    queries = queries.to(torch.float32)
    points = points.to(torch.float32)
    ids = torch.arange(points.shape[0], device=points.device)
    outs = [_merge_best(*_empty_best(qc.shape[0], k, qc.device),
                        _masked_dists(qc, points, valid), ids, k)
            for qc in queries.split(q_chunk)]
    if not outs:
        return (queries.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int64, device=queries.device))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def knn_topk_plain(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of kernel D (the ``pallas_knn`` contract): squared
    distances ``[Q, k]`` f32 ascending and ids ``[Q, k]`` int64, ties to
    the smaller id, ``(1e10, -1)`` while fewer than ``k`` live points."""
    _check_knn_args(queries, points, valid, k)
    if queries.is_cuda:
        kernels.count(kernels.plain_calls, "knn_topk")
    return knn_tiled(queries, points, valid, k)


def _check_knn_args(queries, points, valid, k: int) -> None:
    kernels.require(queries.dim() == 2 and queries.shape[1] == 3, "knn_topk: queries must be [Q, 3]")
    kernels.require(points.dim() == 2 and points.shape[1] == 3, "knn_topk: points must be [P, 3]")
    kernels.require(valid.shape == (points.shape[0],) and valid.dtype == torch.bool,
                    "knn_topk: valid must be bool [P]")
    kernels.require(1 <= k <= MAX_K, f"knn_topk: k must be 1..{MAX_K}")


# ---------------------------------------------------------------------------
# kernel D: plan and launch

KNN_THREADS = 128          # consumer threads a block (csrc/knn_topk.cu kConsumers)
KNN_R = 2                  # queries a thread


@dataclass(frozen=True)
class KnnPlan:
    """Kernel D's launch: ``tiles`` query tiles of ``tile_q = 128 r``
    queries (``r`` a thread), their work (tiles x the live points) cut
    into ``grid`` equal contiguous ranges, one a block: the SMs x the
    blocks an SM holds, one wave."""
    r: int
    tile_q: int
    tiles: int
    grid: int
    sms: int
    blocks_per_sm: int


def knn_plan(nq: int, k: int, num_sms: int, blocks_per_sm: int = 1,
             r: Optional[int] = None, grid: Optional[int] = None) -> KnnPlan:
    """Kernel D's plan, fixed from the query count and the card (the table
    is cut on the card, from its live count): ``r`` queries a thread
    (default ``KNN_R``), a grid of ``num_sms * blocks_per_sm`` blocks;
    ``r`` and ``grid`` force a plan."""
    kernels.require(1 <= k <= MAX_K, f"knn_topk: k must be 1..{MAX_K}")
    r = KNN_R if r is None else r
    kernels.require(r == 2 or (k == 4 and r in (4, 8)),
                    "knn_topk: r is 2, or 4 or 8 at k = 4 (the kernels built)")
    tile_q = KNN_THREADS * r
    grid = num_sms * blocks_per_sm if grid is None else grid
    kernels.require(grid >= 1, "knn_topk: the grid needs a block")
    return KnnPlan(r, tile_q, max(1, -(-nq // tile_q)), grid, num_sms, blocks_per_sm)


def knn_pieces(plan: KnnPlan, n_live: int) -> List[List[Tuple[int, int, int]]]:
    """Each tile's pieces, ``(block, p0, p1)`` over the staged table (the
    live points in id order), in order: the cut ``knn_topk_kernel`` makes
    on the card from the live count.  The work, tiles x ``n_live``, is cut
    into ``min(grid, work)`` ranges ``[b W / G, (b + 1) W / G)``,
    tile-major."""
    W = plan.tiles * n_live
    G = min(plan.grid, W)
    pieces: List[List[Tuple[int, int, int]]] = [[] for _ in range(plan.tiles)]
    for b in range(G):
        u, u1 = b * W // G, (b + 1) * W // G
        while u < u1:
            t = u // n_live
            p1 = min(n_live, u - t * n_live + (u1 - u))
            pieces[t].append((b, u - t * n_live, p1))
            u = t * n_live + p1
    return pieces


def _bind(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.knn_topk.argtypes = [P, I, P, P, I, I, I, I, P, P, P, P, P, P, P, P, P]
    lib.knn_topk.restype = I
    lib.knn_topk_occupancy.argtypes = [I, I, P]
    lib.knn_topk_occupancy.restype = I
    lib._d3_bound = True


_knn_card: Dict[tuple, Tuple[int, int]] = {}   # (device, k, r) -> (SMs, blocks per SM)


def card_plan(device: torch.device, nq: int, k: int, r: Optional[int] = None,
              grid: Optional[int] = None) -> KnnPlan:
    """:func:`knn_plan` with the card's SMs and the blocks an SM holds
    (asked once per device, k and r)."""
    r = KNN_R if r is None else r
    key = (device, k, r)
    card = _knn_card.get(key)
    if card is None:
        lib = kernels.library("knn_topk")
        _bind(lib)
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            kernels.check(lib.knn_topk_occupancy(k, r, out), "knn_topk_occupancy")
        card = _knn_card[key] = (out[0], out[1])
    return knn_plan(nq, k, card[0], card[1], r=r, grid=grid)


def knn_launch(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor, k: int,
               plan: KnnPlan) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel D with ``plan`` (from :func:`card_plan`) on CUDA
    tensors: ``(dist, idx, n_live)``, ``n_live`` the live count the
    prologue wrote (int32 [1])."""
    _check_knn_args(queries, points, valid, k)
    kernels.require_cuda([queries, points, valid], "knn_topk")
    kernels.require(queries.dtype == torch.float32 and points.dtype == torch.float32,
                    "knn_topk: queries and points must be f32")
    kernels.require(not (queries.requires_grad or points.requires_grad),
                    "knn_topk: the kernel has no gradient")
    nq, np_ = queries.shape[0], points.shape[0]
    kernels.require(plan.tile_q * plan.tiles >= nq, "knn_topk: the plan does not cover the queries")
    lib = kernels.library("knn_topk")
    _bind(lib)
    dev = queries.device
    staged = torch.empty((np_ + 4, 4), dtype=torch.float32, device=dev)
    sid = torch.empty(np_ + 8, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    n_part = 2 * plan.grid * plan.tile_q * k
    part_d = torch.empty(n_part, dtype=torch.float32, device=dev)
    part_i = torch.empty(n_part, dtype=torch.int32, device=dev)
    tickets = _ticket_buffer(dev, plan.tiles)
    dist = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    rc = lib.knn_topk(queries.data_ptr(), nq, points.data_ptr(), valid.data_ptr(), np_, k,
                      plan.r, plan.grid, staged.data_ptr(), sid.data_ptr(), n_live.data_ptr(),
                      part_d.data_ptr(), part_i.data_ptr(), tickets.data_ptr(), dist.data_ptr(),
                      idx.data_ptr(), kernels.stream_ptr(queries))
    kernels.check(rc, "knn_topk")
    kernels.count(kernels.launches, "knn_topk")
    return dist, idx, n_live


def knn_topk_cuda(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel D (``csrc/knn_topk.cu``) on CUDA tensors, with the
    card's plan."""
    kernels.require(queries.is_cuda, "knn_topk: queries must be on a CUDA device")
    plan = card_plan(queries.device, queries.shape[0], k)
    return knn_launch(queries, points, valid, k, plan)[:2]


def knn_topk(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D on CUDA tensors, its plain version on CPU tensors."""
    if queries.is_cuda:
        return knn_topk_cuda(queries, points, valid, k)
    return knn_topk_plain(queries, points, valid, k)


def knn_auto(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The large ray-query k-NN: kernel D for CUDA tensors of at least 1024
    points when ``DYNAM3D_ENABLE_PALLAS_KNN`` is set, :func:`knn_tiled`
    otherwise (the reference's dispatch rule)."""
    if queries.is_cuda and points.shape[0] >= 1024 and flags.enable_pallas_knn():
        return knn_topk(queries.contiguous(), points.contiguous(), valid.contiguous(), k)
    return knn_tiled(queries, points, valid, k)


# ---------------------------------------------------------------------------
# banded scan of ray-structured queries

def knn_banded(q_struct: torch.Tensor, points: torch.Tensor, valid: torch.Tensor, k: int,
               radius: float, tile: int = 2048, band: int = 32,
               with_indices: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius-exact k-NN of ray-structured queries ``[R, NS, 3]``.

    Queries are cut into depth bands of ``band`` samples of every ray and
    the table into ``tile``-point tiles; a (band, tile) pair whose bounding
    boxes lie at least ``radius`` apart is skipped.  Exact for every
    neighbour within ``radius``; beyond it a distance may read 1e10.  The
    whole ``near [bands, tiles]`` mask is computed on the device and read
    back once; each band then scans its near tiles, eight at a time.
    Returns flat ``(sq_dists [R*NS, k], indices [R*NS, k])``; with
    ``with_indices=False`` the indices are all -1."""
    R, NS, _ = q_struct.shape
    dev = q_struct.device
    nb = -(-NS // band)
    qp = torch.cat([q_struct.to(torch.float32),
                    q_struct.new_full((R, nb * band - NS, 3), 1e6, dtype=torch.float32)], dim=1)
    qb = qp.reshape(R, nb, band, 3).transpose(0, 1).reshape(nb, R * band, 3)

    P = points.shape[0]
    ppad = (-P) % tile
    pp = torch.cat([points.to(torch.float32), points.new_zeros((ppad, 3), dtype=torch.float32)])
    vp = torch.cat([valid, valid.new_zeros(ppad)])
    nt = pp.shape[0] // tile
    pts_t, val_t = pp.reshape(nt, tile, 3), vp.reshape(nt, tile)
    inf = torch.tensor(float("inf"), device=dev)
    t_lo = torch.where(val_t[..., None], pts_t, inf).amin(dim=1)          # [nt, 3]
    t_hi = torch.where(val_t[..., None], pts_t, -inf).amax(dim=1)
    real = qb[..., 0] < 1e5                                               # [nb, Qb]
    b_lo = torch.where(real[..., None], qb, inf).amin(dim=1)              # [nb, 3]
    b_hi = torch.where(real[..., None], qb, -inf).amax(dim=1)
    gap = torch.clamp(torch.maximum(t_lo[None] - b_hi[:, None], b_lo[:, None] - t_hi[None]),
                      min=0.0)
    near = ((gap * gap).sum(-1) < radius * radius).cpu()                  # [nb, nt], one read

    dists, inds = [], []
    for b in range(nb):
        qc = qb[b]
        bd, bi = _empty_best(qc.shape[0], k, dev)
        tiles = torch.nonzero(near[b]).flatten().tolist()
        for g in range(0, len(tiles), _TILE_GROUP):
            sel = torch.tensor(tiles[g: g + _TILE_GROUP], device=dev)
            ids = (sel[:, None] * tile + torch.arange(tile, device=dev)[None]).flatten()
            d = _masked_dists(qc, pts_t[sel].reshape(-1, 3), val_t[sel].flatten())
            if with_indices:
                bd, bi = _merge_best(bd, bi, d, ids, k)
            else:
                bd = torch.topk(torch.cat([bd, d], 1), k, dim=1, largest=False,
                                sorted=True).values
        dists.append(bd)
        inds.append(bi)
    d = torch.stack(dists).reshape(nb, R, band, k).transpose(0, 1).reshape(R, nb * band, k)
    i = torch.stack(inds).reshape(nb, R, band, k).transpose(0, 1).reshape(R, nb * band, k)
    return d[:, :NS].reshape(R * NS, k), i[:, :NS].reshape(R * NS, k)


# ---------------------------------------------------------------------------
# Morton order of the patch table

def _spread10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` to every 3rd bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes over the live points' bounding box (10 bits an
    axis); dead slots get the largest int32 so a sort puts them last."""
    inf = torch.tensor(float("inf"), device=points.device)
    lo = torch.where(valid[:, None], points, inf).amin(dim=0)
    hi = torch.where(valid[:, None], points, -inf).amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((points - lo) / span * 1023.0, 0.0, 1023.0)
    q = torch.nan_to_num(q).to(torch.int32)
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    return torch.where(valid, code, torch.full_like(code, 0x7FFFFFFF))


def morton_perm(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Permutation sorting the table into Morton order (dead slots last),
    stable."""
    return torch.argsort(morton_codes(points, valid), stable=True)
