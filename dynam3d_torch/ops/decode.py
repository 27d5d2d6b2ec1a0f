"""Phi-3 decode layers over packed int4 weights (kernels A, B and H).

Port of ``ops/pallas_decode.py::decode_layer_ring`` and, at the end of this
module, ``decode_attn_layer`` (kernel H, the attention half of the split
route).  The TPU ring kernel is one program per layer with a hand-scheduled
DMA ring; on the card the ring layer is five launches and no glue in
between:

  1. int4_matvec  (rmsnorm prologue, qkv)              -> y f32 [B, 3D]
  2. decode_attn  (RoPE, cache + in-flight rows)        -> ctx, k_new, v_new
  3. int4_matvec  (o, residual epilogue)                -> o1 f32 [B, D]
  4. int4_matvec  (rmsnorm prologue, gate_up, SwiGLU)   -> h bf16 [B, I]
  5. int4_matvec  (down, residual epilogue)             -> x_out bf16 [B, D]

The three modes of the TPU kernel (plain, ``shared_cache`` and
``group_size``) are one ``group`` parameter of kernel B and of the layer:
row b attends cache row b//group and folds the new k/v of its group's rows
up to itself.  ``group=1`` is plain (each row its own cache row),
``group=B`` the shared cache (every row attends cache row 0, row r folds
draft rows 0..r) and ``1 < group < B`` the grouped verify (B/group
episodes of ``group`` draft rows).  Kernel B takes up to
``ATTN_ROWS`` = 16 rows a call in groups of at most ``GROUP_ROWS`` = 8: the
ring layer runs at most ``MAX_ROWS`` = 8, and ``phi3``'s wide route calls
kernel B alone in plain mode at B = 9..16.

Numerics (kernels B and H): all attention arithmetic is f32 (the TPU
kernels' bf16 roundings of ``k*q`` products and of the rescale lanes are not
reproduced); q/k/v and the context are rounded to bf16 as the cache stores
them.  On the tensor cores (``csrc/decode_attn.cuh``) the scores are exact
products of bf16 values summed in f32, and the probabilities P enter the
context product split in two bf16 parts, P = P_hi + P_lo (relative error
about 2^-17), each multiplied by V in its own mma.  The ring's residual
between the attention and MLP halves stays f32; kernel H rounds its output
to bf16, as the split route's reference does.

Both kernels split each (head, cache group)'s scan into work items of 64-row
tiles (:func:`attn_splits`, :func:`attn_plan`); every query row of the group
is scored against one pass over the item's rows, and the splits are merged
in order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from dynam3d_torch.ops import kernels
from dynam3d_torch.ops.int4 import (
    Int4Weight, _matvec_math, _ticket_buffer, _tiles, int4_matvec, int4_matvec_cuda,
    int4_matvec_plain, plan,
)

ROWS = 512        # cache rows per scan block (Tmax must be a multiple)
MAX_ROWS = 8      # batch rows per decode layer
ATTN_ROWS = 16    # query rows per kernel B call (csrc/decode_attn.cu: kMaxBatch)
GROUP_ROWS = 8    # query rows of one cache group (csrc/decode_attn.cuh: kMaxRows)
TILE = 64         # cache rows per tile of the attention body (csrc/decode_attn.cuh)
MAX_SPLITS = 32   # sequence splits per (head, group) the body merges


def scan_length(pos: int, tmax: int) -> int:
    """Cache rows a layer reads: up to the 512-row block holding the last
    write slot ``pos`` (the TPU kernel streams ``ceil(pos/512)`` blocks);
    the mask must be False beyond the write slots."""
    return min(tmax, -(-int(pos) // ROWS) * ROWS)


def attn_splits(slots: int, pairs: int, t_scan: int) -> Tuple[int, int]:
    """``(nsplit, tps)``: the sequence splits of each of ``pairs`` (head,
    cache group) pairs and the 64-row tiles per split.  As many splits as
    keep the work items (pairs x splits) within ``slots`` (at least one),
    but no more than the tiles or MAX_SPLITS; then as few splits as that
    many tiles per split needs (the last split may have fewer tiles).  No
    rows: one empty split."""
    tiles = -(-t_scan // TILE)
    if tiles == 0:
        return 1, 0
    want = min(max(1, slots // pairs), tiles, MAX_SPLITS)
    tps = -(-tiles // want)
    return -(-tiles // tps), tps


class AttnPlan(NamedTuple):
    """Kernel B's launch: splits, tiles per split and work items (one block
    each), the card's SMs and blocks per SM, and the waves the items make."""
    nsplit: int
    tps: int
    items: int
    sms: int
    blocks_per_sm: int
    waves: float


_attn_card: Dict[tuple, Tuple[int, int]] = {}   # (device, hd) -> (SMs, blocks per SM)
_attn_plans: Dict[tuple, AttnPlan] = {}


def attn_plan(device: torch.device, hd: int, heads: int, groups: int, t_scan: int) -> AttnPlan:
    """Kernel B's plan: as many splits as keep the work items to one per SM
    (the kernel takes one block per SM, registers for no spills at hd 96);
    at Phi-3-mini widths and 1024 cache rows that is 4 / 4 / 2 splits in
    the plain / shared-cache / grouped modes, the fastest of 1-16 in each
    (``tools/decompose_decode_attn``).  Cached per shape and device, the
    card's answers per (device, hd)."""
    key = (device, hd, heads, groups, t_scan)
    got = _attn_plans.get(key)
    if got is None:
        card = _attn_card.get((device, hd))
        if card is None:
            lib = kernels.library("decode_attn")
            _bind(lib)
            out = (ctypes.c_int * 2)()
            kernels.check(lib.decode_attn_occupancy(hd, out), "decode_attn_occupancy")
            card = _attn_card[(device, hd)] = (out[0], out[1])
        sms, per_sm = card
        nsplit, tps = attn_splits(sms, heads * groups, t_scan)
        items = heads * groups * nsplit
        got = _attn_plans[key] = AttnPlan(nsplit, tps, items, sms, per_sm,
                                          items / (sms * per_sm))
    return got


def _rows2d(t: torch.Tensor, rows: int) -> Tuple[torch.Tensor, int]:
    """A [rows, n] view of a per-row table given as [n], [1, n] or
    [rows, n]; the second value is the row stride (0 broadcasts)."""
    t2 = t.reshape(-1, t.shape[-1])
    if t2.shape[0] == 1 and rows > 1:
        return t2.expand(rows, -1), 0
    kernels.require(t2.shape[0] == rows, "decode_attn: per-row table has wrong rows")
    return t2, t2.shape[1]


def _check_attn(qkv, cache_k, cache_v, group, heads, hd):
    rows, w3 = qkv.shape
    D = heads * hd
    kernels.require(w3 == 3 * D, "decode_attn: qkv must be [rows, 3*heads*hd]")
    kernels.require(1 <= rows <= ATTN_ROWS, f"decode_attn: rows must be 1..{ATTN_ROWS}")
    kernels.require(1 <= group <= GROUP_ROWS, f"decode_attn: group must be 1..{GROUP_ROWS}")
    kernels.require(rows % group == 0, "decode_attn: rows % group != 0")
    kernels.require(cache_k.shape == cache_v.shape and cache_k.shape[-1] == D,
                    "decode_attn: caches must be [L, Bc, Tmax, D]")
    kernels.require(cache_k.shape[1] >= rows // group,
                    "decode_attn: too few cache rows for the groups")


def decode_attn_plain(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, li: int,
    mask: torch.Tensor, t_scan: int, group: int, *, heads: int, hd: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PyTorch version of kernel B (any device): returns bf16
    ``(ctx [B, D], k_new [B, D], v_new [B, D])``."""
    _check_attn(qkv, cache_k, cache_v, group, heads, hd)
    if qkv.is_cuda:
        kernels.count(kernels.plain_calls, "decode_attn")
    return _attn_math(qkv, cos, sin, cache_k, cache_v, li, mask, t_scan, group, heads, hd)


def _attn_math(qkv, cos, sin, cache_k, cache_v, li, mask, t_scan, group, heads, hd):
    B = qkv.shape[0]
    D = heads * hd
    half = hd // 2
    cos2, _ = _rows2d(cos.to(torch.float32), B)
    sin2, _ = _rows2d(sin.to(torch.float32), B)
    mask2, _ = _rows2d(mask.to(torch.bool), B)
    y = qkv.to(torch.float32).view(B, 3, heads, hd)

    def rope(t):                                     # [B, H, hd] f32
        c, s = cos2[:, None, :], sin2[:, None, :]
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

    q = rope(y[:, 0]).to(torch.bfloat16).to(torch.float32)
    k_r = rope(y[:, 1]).to(torch.bfloat16)
    v_r = y[:, 2].to(torch.bfloat16)
    kf, vf = k_r.to(torch.float32), v_r.to(torch.float32)
    scale = 1.0 / math.sqrt(hd)
    ctx = torch.empty((B, heads, hd), dtype=torch.float32, device=qkv.device)
    for r in range(B):
        g0 = (r // group) * group
        c = r // group
        kc = cache_k[li, c, :t_scan].to(torch.float32).view(t_scan, heads, hd)
        vc = cache_v[li, c, :t_scan].to(torch.float32).view(t_scan, heads, hd)
        keys = torch.cat([kc, kf[g0 : r + 1]], dim=0)             # [T', H, hd]
        vals = torch.cat([vc, vf[g0 : r + 1]], dim=0)
        live = torch.cat([mask2[r, :t_scan],
                          torch.ones(r + 1 - g0, dtype=torch.bool, device=qkv.device)])
        logits = torch.einsum("hd,thd->ht", q[r], keys) * scale
        logits = logits.masked_fill(~live[None, :], float("-inf"))
        p = torch.softmax(logits, dim=-1)
        ctx[r] = torch.einsum("ht,thd->hd", p, vals)
    return (ctx.reshape(B, D).to(torch.bfloat16), k_r.reshape(B, D).contiguous(),
            v_r.reshape(B, D).contiguous())


def _bind(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attn.argtypes = [
        P, I, I, I, I, P, P, I, P, P, I, I, I, P, I, I, I, F, P, P, P, I, I, P, P, P,
    ]
    lib.decode_attn.restype = I
    lib.decode_attn_occupancy.argtypes = [I, P]
    lib.decode_attn_occupancy.restype = I
    lib._d3_bound = True


def decode_attn_cuda(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, li: int,
    mask: torch.Tensor, t_scan: int, group: int, *, heads: int, hd: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel B (``csrc/decode_attn.cu``) on CUDA tensors."""
    _check_attn(qkv, cache_k, cache_v, group, heads, hd)
    B = qkv.shape[0]
    D = heads * hd
    kernels.require(qkv.dtype == torch.float32, "decode_attn: qkv must be f32")
    kernels.require(cache_k.dtype == torch.bfloat16 and cache_v.dtype == torch.bfloat16,
                    "decode_attn: caches must be bf16")
    kernels.require(cos.dtype == torch.float32 and sin.dtype == torch.float32,
                    "decode_attn: cos/sin must be f32")
    kernels.require(mask.dtype == torch.bool, "decode_attn: mask must be bool")
    kernels.require(hd in (32, 64, 96, 128), f"decode_attn: head dim {hd} unsupported")
    tmax = cache_k.shape[2]
    kernels.require(0 <= t_scan <= tmax and t_scan <= mask.shape[-1],
                    "decode_attn: scan length out of range")
    cos2, cs_stride = _rows2d(cos, B)
    sin2, _ = _rows2d(sin, B)
    mask2, m_stride = _rows2d(mask, B)
    kernels.require(cos2.shape[1] == hd // 2, "decode_attn: cos/sin must be [B, hd/2]")
    kernels.require_cuda([qkv, cache_k, cache_v, cos, sin, mask], "decode_attn")
    lib = kernels.library("decode_attn")
    _bind(lib)
    dev = qkv.device
    pl = attn_plan(dev, hd, heads, B // group, int(t_scan))
    ctx = torch.empty((B, D), dtype=torch.bfloat16, device=dev)
    k_new = torch.empty_like(ctx)
    v_new = torch.empty_like(ctx)
    ws = torch.empty(pl.items * GROUP_ROWS * (2 + hd), dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, heads * (B // group))
    rc = lib.decode_attn(
        qkv.data_ptr(), B, D, heads, hd, cos2.data_ptr(), sin2.data_ptr(),
        cs_stride, cache_k.data_ptr(), cache_v.data_ptr(), cache_k.shape[1],
        tmax, int(li), mask2.data_ptr(), m_stride, int(t_scan), int(group),
        1.0 / math.sqrt(hd), ctx.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pl.nsplit, pl.tps, ws.data_ptr(), tickets.data_ptr(), kernels.stream_ptr(qkv),
    )
    kernels.check(rc, "decode_attn")
    kernels.count(kernels.launches, "decode_attn")
    return ctx, k_new, v_new


def decode_attn(qkv, cos, sin, cache_k, cache_v, li, mask, t_scan, group, *,
                heads: int, hd: int):
    """Kernel B on CUDA tensors, its plain version on CPU tensors."""
    fn = decode_attn_cuda if qkv.is_cuda else decode_attn_plain
    return fn(qkv, cos, sin, cache_k, cache_v, li, mask, t_scan, group,
              heads=heads, hd=hd)


def _layer(matvec, attn, x, ln1_w, qkv, o, ln2_w, gate_up, down, cache_k,
           cache_v, li, t_scan, mask, cos, sin, eps, heads, hd, group):
    B = x.shape[0]
    D = x.shape[-1]
    kernels.require(1 <= B <= MAX_ROWS, f"decode_layer_ring: B must be 1..{MAX_ROWS}")
    kernels.require(cache_k.shape[2] % ROWS == 0,
                    f"decode_layer_ring: Tmax must be a multiple of {ROWS}")
    kernels.require(qkv.n == 3 * D and qkv.d == D and o.d == D and o.n == D,
                    "decode_layer_ring: qkv/o shapes")
    kernels.require(gate_up.d == D and down.n == D and gate_up.n == 2 * gate_up.n2,
                    "decode_layer_ring: gate_up/down shapes")
    x2 = x.reshape(B, D)
    y = matvec(x2, qkv, ln_w=ln1_w, eps=eps, out_dtype=torch.float32)
    ctx, k_new, v_new = attn(y, cos, sin, cache_k, cache_v, li, mask, t_scan,
                             group, heads=heads, hd=hd)
    o1 = matvec(ctx, o, residual=x2, epilogue="residual", out_dtype=torch.float32)
    h = matvec(o1, gate_up, ln_w=ln2_w, eps=eps, epilogue="swiglu",
               out_dtype=torch.bfloat16)
    out = matvec(h, down, residual=o1, epilogue="residual", out_dtype=torch.bfloat16)
    return out.view(B, 1, D), k_new, v_new


def decode_layer_ring(
    x: torch.Tensor,            # [B, 1, D] bf16, B <= 8
    ln1_w: torch.Tensor,        # [D] f32
    qkv: Int4Weight,
    o: Int4Weight,
    ln2_w: torch.Tensor,
    gate_up: Int4Weight,
    down: Int4Weight,
    cache_k: torch.Tensor,      # [L, Bc, Tmax, D] bf16
    cache_v: torch.Tensor,
    li: int,
    t_scan: int,                # cache rows read (scan_length of the last write slot)
    mask: torch.Tensor,         # [Tmax] or [B, Tmax] bool, current slots excluded
    cos: torch.Tensor,          # [hd/2] or [B, hd/2] f32
    sin: torch.Tensor,
    *,
    eps: float,
    heads: int,
    hd: int,
    group: int = 1,             # rows per cache row (B % group == 0)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode layer; returns ``(x_out [B,1,D], k_new [B,D], v_new [B,D])``
    in bf16 for the caller's cache write.  Five kernel launches on CUDA
    tensors, the plain versions on CPU tensors."""
    return _layer(int4_matvec, decode_attn, x, ln1_w, qkv, o, ln2_w, gate_up,
                  down, cache_k, cache_v, li, t_scan, mask, cos, sin, eps, heads,
                  hd, group)


def decode_layer_ring_plain(x, ln1_w, qkv, o, ln2_w, gate_up, down, cache_k,
                            cache_v, li, t_scan, mask, cos, sin, *, eps, heads,
                            hd, group=1):
    """The layer through the plain versions only, on any device."""
    return _layer(int4_matvec_plain, decode_attn_plain, x, ln1_w, qkv, o,
                  ln2_w, gate_up, down, cache_k, cache_v, li, t_scan, mask, cos,
                  sin, eps, heads, hd, group)


def decode_layer_ring_cuda(x, ln1_w, qkv, o, ln2_w, gate_up, down, cache_k,
                           cache_v, li, t_scan, mask, cos, sin, *, eps, heads,
                           hd, group=1):
    """The layer through the kernels only (CUDA tensors)."""
    return _layer(int4_matvec_cuda, decode_attn_cuda, x, ln1_w, qkv, o,
                  ln2_w, gate_up, down, cache_k, cache_v, li, t_scan, mask, cos,
                  sin, eps, heads, hd, group)


# ---------------------------------------------------------------- kernel H

def _check_attn_layer(x, qkv, o, cache_k, cache_v, mask, cos, heads, hd):
    D = x.shape[-1]
    kernels.require(x.numel() == D, "decode_attn_layer: x must be [1, 1, D] (B = 1)")
    kernels.require(heads * hd == D, "decode_attn_layer: heads * hd must be D")
    kernels.require(qkv.d == D and qkv.n == 3 * D == 2 * qkv.n2,
                    "decode_attn_layer: qkv must be an unpadded D -> 3D pack")
    kernels.require(o.d == D and o.n == D == 2 * o.n2,
                    "decode_attn_layer: o must be an unpadded D -> D pack")
    kernels.require(qkv.dblk == o.dblk, "decode_attn_layer: qkv and o dblk differ")
    kernels.require(cache_k.shape == cache_v.shape and cache_k.dim() == 4
                    and cache_k.shape[-1] == D, "decode_attn_layer: caches must be [L, Bc, Tmax, D]")
    kernels.require(cache_k.shape[2] % ROWS == 0,
                    f"decode_attn_layer: Tmax must be a multiple of {ROWS}")
    kernels.require(mask.shape == (cache_k.shape[2],), "decode_attn_layer: mask must be [Tmax]")
    kernels.require(cos.numel() == hd // 2, "decode_attn_layer: cos/sin must be [hd/2]")


def decode_attn_layer_plain(x, ln_w, qkv, o, cache_k, cache_v, li, pos, mask, cos, sin, *,
                            eps: float, heads: int, hd: int):
    """PyTorch version of kernel H (any device): the rmsnorm + qkv matvec of
    kernel A's arithmetic, kernel B's attention (one row, group 1), the o
    matvec + residual rounded to bf16."""
    _check_attn_layer(x, qkv, o, cache_k, cache_v, mask, cos, heads, hd)
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "decode_attn_layer")
    D = x.shape[-1]
    x2 = x.reshape(1, D)
    y = _matvec_math(x2, qkv, ln_w=ln_w, eps=eps)
    ctx, k_new, v_new = _attn_math(y, cos, sin, cache_k, cache_v, li, mask,
                                   scan_length(pos, cache_k.shape[2]), 1, heads, hd)
    out = _matvec_math(ctx, o, residual=x2, epilogue="residual", out_dtype=torch.bfloat16)
    return out.view(1, 1, D), k_new, v_new


def _bind_attn_layer(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attn_layer_plan.argtypes = [I, I, I, I, I, I, P]
    lib.decode_attn_layer_plan.restype = I
    lib.decode_attn_layer.argtypes = [
        P, I, P, F, P, P, P, I, I, P, P, P, I, I, I, I, I, I, P, P, P, P, I, I, I, P, I, I,
        I, F, I, I, P, P, P, P, P, P, P, P, P, P,
    ]
    lib.decode_attn_layer.restype = I
    lib._d3_bound = True


def decode_attn_layer_cuda(x, ln_w, qkv, o, cache_k, cache_v, li, pos, mask, cos, sin, *,
                           eps: float, heads: int, hd: int):
    """Launch kernel H (``csrc/decode_attn_layer.cu``, one cooperative
    launch) on CUDA tensors."""
    _check_attn_layer(x, qkv, o, cache_k, cache_v, mask, cos, heads, hd)
    tensors = [x, ln_w, qkv.q4, qkv.s_lo, qkv.s_hi, o.q4, o.s_lo, o.s_hi, cache_k, cache_v,
               mask, cos, sin]
    kernels.require_cuda(tensors, "decode_attn_layer")
    kernels.require(x.dtype == torch.bfloat16 and cache_k.dtype == torch.bfloat16
                    and cache_v.dtype == torch.bfloat16,
                    "decode_attn_layer: x and the caches must be bf16")
    kernels.require(ln_w.dtype == torch.float32 and cos.dtype == torch.float32
                    and sin.dtype == torch.float32 and mask.dtype == torch.bool,
                    "decode_attn_layer: ln_w/cos/sin must be f32 and mask bool")
    kernels.require(hd in (32, 64, 96, 128), f"decode_attn_layer: head dim {hd} unsupported")
    for w in (qkv, o):
        kernels.require(w.q4.dtype == torch.int8 and w.s_lo.dtype == torch.float32,
                        "decode_attn_layer: q4 must be int8 and scales f32")
    lib = kernels.library("decode_attn_layer")
    _bind_attn_layer(lib)
    D = x.shape[-1]
    dev = x.device
    grid, ks1, ks3 = plan(lib, "decode_attn_layer_plan", dev, hd, qkv.dp, qkv.n2, o.dp, o.n2,
                          qkv.dblk)
    t_scan = scan_length(pos, cache_k.shape[2])
    nsplit, tps = attn_splits(grid, heads, t_scan)
    y = torch.empty(3 * D, dtype=torch.float32, device=dev)
    ctx = torch.empty(D, dtype=torch.bfloat16, device=dev)
    out = torch.empty((1, 1, D), dtype=torch.bfloat16, device=dev)
    k_new = torch.empty((1, D), dtype=torch.bfloat16, device=dev)
    v_new = torch.empty_like(k_new)
    ws1 = torch.empty((qkv.dp // ks1) * 2 * qkv.n2, dtype=torch.float32, device=dev)
    ws2 = torch.empty(heads * nsplit * (2 + hd), dtype=torch.float32, device=dev)
    ws3 = torch.empty((o.dp // ks3) * 2 * o.n2, dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, _tiles(qkv.n2) + _tiles(o.n2) + heads)
    rc = lib.decode_attn_layer(
        x.data_ptr(), D, ln_w.data_ptr(), float(eps), qkv.q4.data_ptr(), qkv.s_lo.data_ptr(),
        qkv.s_hi.data_ptr(), qkv.dp, qkv.n2, o.q4.data_ptr(), o.s_lo.data_ptr(),
        o.s_hi.data_ptr(), o.dp, o.n2, qkv.dblk, grid, ks1, ks3, cos.data_ptr(),
        sin.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), cache_k.shape[1],
        cache_k.shape[2], int(li), mask.data_ptr(), t_scan, heads, hd, 1.0 / math.sqrt(hd),
        nsplit, tps, y.data_ptr(), ctx.data_ptr(), out.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ws1.data_ptr(), ws2.data_ptr(), ws3.data_ptr(), tickets.data_ptr(),
        kernels.stream_ptr(x),
    )
    kernels.check(rc, "decode_attn_layer")
    kernels.count(kernels.launches, "decode_attn_layer")
    return out, k_new, v_new


def decode_attn_layer(
    x: torch.Tensor,            # [1, 1, D] bf16 (B = 1)
    ln_w: torch.Tensor,         # [D] f32
    qkv: Int4Weight,            # D -> 3D
    o: Int4Weight,              # D -> D
    cache_k: torch.Tensor,      # [L, Bc, Tmax, D] bf16 (cache row 0 is read)
    cache_v: torch.Tensor,
    li: int,
    pos: int,                   # the write slot
    mask: torch.Tensor,         # [Tmax] bool, the write slot excluded
    cos: torch.Tensor,          # [hd/2] f32
    sin: torch.Tensor,
    *,
    eps: float,
    heads: int,
    hd: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention half of a decode layer (``pallas_decode.decode_attn_layer``):
    returns ``(x_out [1, 1, D], k_new [1, D], v_new [1, D])`` in bf16, with
    ``x_out = x + o(attention)``; the caller writes k_new/v_new at ``pos``.
    Kernel H on CUDA tensors, its plain version on CPU tensors."""
    fn = decode_attn_layer_cuda if x.is_cuda else decode_attn_layer_plain
    return fn(x, ln_w, qkv, o, cache_k, cache_v, li, pos, mask, cos, sin, eps=eps,
              heads=heads, hd=hd)
