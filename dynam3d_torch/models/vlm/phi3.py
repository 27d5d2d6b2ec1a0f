"""Phi-3-mini decoder with KV-cache prefill and (speculative) greedy decode.

Port of ``models/vlm/phi3.py``: ``rms_norm``, ``_rope``,
``init_cache``, ``forward`` (with ``lm_at`` and per-row write slots), the
training forward ``forward_train``, the weight-format dispatch
``_mm`` (dense, int8 W8A8 prefill, int4 matvec) and ``_mlp`` (fused int4
MLP), ``_lm_head``, ``decode_forward``, the route decision
``decode_route``, the ring stack ``_ring_stack``, greedy's fused passes
(``_decode_forward_ring``, ``_decode_forward_split`` and the wide route
``_decode_forward_wide``), the B=1 speculative ring pass ``_ring_pass``,
``_last_valid_idx``, ``_ngram_draft``, ``greedy_decode``,
``greedy_decode_spec`` (B = 1..4), ``init_phi3_params`` and
``quantize_phi3``.

Int4 decode takes the reference's routes, which :func:`decode_route`
chooses from the pass's rows, the packing and the decode flags (read at
call time), the same on either device:

* ``"ring"`` (``_ring_stack`` over ``ops.decode.decode_layer_ring``,
  kernels B + 4 x A) for B <= 8 rows: greedy in plain mode, the B=1
  speculative verify with the rows sharing cache row 0, and the grouped
  B=2..4 verify;
* ``"split"`` at B=1 with ``DYNAM3D_FUSED_RING=0``: kernel H
  (``decode_attn_layer``) then kernel G (``int4_mlp_block``) per layer;
* ``"wide"`` for greedy B = 9..16 (``_decode_forward_wide``): kernel A
  for qkv and o, kernel B in plain mode over the bf16 cache, and the MLP of
  ``_mlp`` (kernel F);
* otherwise ``"unfused"``, ``forward``: ``int4_matmul`` (kernel A, or
  E under ``DYNAM3D_INT4_GRID2D``) and ``int4_mlp`` (kernel F).

Tensor parallelism (``tp``: a process group, ``None`` by default) takes
the split ``wq/wk/wv``, ``wgate/wup`` layout of ``parallel.split_qkv_params``
sharded by ``parallel.shard_tree``: heads and MLP columns split, ``o`` and
``down`` row-split with one all-reduce each, the embedding and the
``lm_head`` split over the vocabulary (``parallel/comm.py`` holds the
collectives).  Under TP decode takes the unfused dense route.

Kernels run on CUDA tensors, their plain versions on CPU tensors.  The
decode loops run on the host (Python control flow), reading the argmax of
each pass back from the device.  ``greedy_decode_spec``'s B=1 ring passes
run over long-lived buffers (``_ring_pass``), so that on the card each
pass is the replay of a CUDA graph captured once per ``(rows, Tmax,
t_scan)``.  Each greedy route records the spans
``generate.prefill`` (closing at the first read of the prefill's token)
and ``generate.pass`` (one a pass, closing at its argmax read), and counts
``decode.passes`` and its reads as ``sync`` (``runtime/profiling.py``); the
wide route's passes also count ``decode.wide_passes``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dynam3d_torch import flags
from dynam3d_torch.config import Phi3Config
from dynam3d_torch.device import resolve_device
from dynam3d_torch.ops import int4, kernels
from dynam3d_torch.ops.decode import (
    ATTN_ROWS, MAX_ROWS, ROWS, decode_attn, decode_attn_layer, decode_layer_ring, scan_length,
)
from dynam3d_torch.ops.int4 import int4_matmul, int4_matvec, int4_mlp, int4_mlp_block, pack_int4
from dynam3d_torch.ops.transformer import dot_f32
from dynam3d_torch.parallel.comm import (
    copy_to_tp, gather_from_tp, group_rank, group_size, reduce_from_tp,
)
from dynam3d_torch.runtime import profiling

Params = Dict[str, Any]


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _freqs(cfg: Phi3Config, device) -> torch.Tensor:
    half = cfg.head_dim // 2
    return cfg.rope_theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the full head dim, rotate-half pairs (i, i+hd/2);
    ``x [..., T, H, hd]``, ``positions [..., T]``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor   # [L, B, T, H, hd] (or the flat [L, B, T, D] view)
    v: torch.Tensor


def init_cache(cfg: Phi3Config, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    """Zeroed K/V caches on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _rows(x: torch.Tensor) -> int:
    return int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1


def _mm(w, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Matmul against a dense weight, an int8 ``{q, s}`` pack, or — for at
    most 16 rows, when a packed ``q4`` rides alongside — the int4 matvec.
    With ``flags.W8A8_PREFILL`` larger row counts also quantize the
    activations per token and run an int8 x int8 -> int32 product."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, dict) and "q" in w:
        rows = _rows(x)
        if "q4" in w and rows <= 16:
            return int4_matmul(x, w["q4"], out_dtype=out_dtype)
        if flags.W8A8_PREFILL and rows > 16:
            xf = x.to(torch.float32)
            am = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
            aq = torch.clamp(torch.round(xf / am), -127, 127).to(torch.int8)
            acc = _int8_matmul(aq.reshape(-1, aq.shape[-1]), w["q"])
            acc = acc.reshape(*x.shape[:-1], w["q"].shape[1])
            return (acc.to(torch.float32) * am * w["s"]).to(out_dtype)
        y = dot_f32(x, w["q"].to(x.dtype))
        return (y * w["s"]).to(out_dtype)
    return dot_f32(x, w).to(out_dtype)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``int8 [M, K] @ int8 [K, N] -> int32``: ``torch._int_mm`` on
    the card; on the CPU a float64 product (exact for these magnitudes)."""
    if a.is_cuda:
        return torch._int_mm(a.contiguous(), b)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _mlp(p: Params, h: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """SwiGLU MLP; decode-regime int4 weights go through :func:`int4_mlp`
    (gate and up in f32, h rounded once), others through two ``_mm``.  The
    split ``wgate/wup`` layout (TP: a rank's slice of the columns) takes
    two products instead of one split of ``gate_up``."""
    if "wgate" in p:
        act = torch.nn.functional.silu(_mm(p["wgate"], h)) * _mm(p["wup"], h)
        return _mm(p["down"], act, out_dtype=out_dtype)
    gu, dn = p["gate_up"], p["down"]
    if _q4(gu) is not None and _q4(dn) is not None and _rows(h) <= 16:
        return int4_mlp(h, gu["q4"], dn["q4"], out_dtype=h.dtype)
    gate_up = _mm(gu, h)
    gate, up = gate_up.chunk(2, dim=-1)
    return _mm(dn, torch.nn.functional.silu(gate) * up, out_dtype=out_dtype)


def _qkv(p: Params, cfg: Phi3Config, x: torch.Tensor, positions: torch.Tensor, tp=None):
    """Pre-attention norm, projections and RoPE.  Two layouts: the fused
    ``qkv``, or split ``wq/wk/wv`` (``parallel.split_qkv_params``), whose
    head counts come from the weights' widths, so a rank's column slice
    gives its own heads.  Under ``tp`` the normed input enters the
    column-parallel products through *f* (gradient all-reduced)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = copy_to_tp(rms_norm(p["input_ln"], x, cfg.rms_eps), tp)
    if "wq" in p:
        q, k, v = (_mm(p[n], h) for n in ("wq", "wk", "wv"))
        q = q.reshape(B, T, -1, hd)
        k = k.reshape(B, T, -1, hd)
        v = v.reshape(B, T, -1, hd)
    else:
        if tp is not None:
            raise ValueError("tensor parallelism needs the split layout (split_qkv_params)")
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        qkv = _mm(p["qkv"], h)
        q_sz, kv_sz = H * hd, Hkv * hd
        q = qkv[..., :q_sz].reshape(B, T, H, hd)
        k = qkv[..., q_sz: q_sz + kv_sz].reshape(B, T, Hkv, hd)
        v = qkv[..., q_sz + kv_sz:].reshape(B, T, Hkv, hd)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _attn_mlp(p: Params, cfg: Phi3Config, x: torch.Tensor, q: torch.Tensor,
              kv_k: torch.Tensor, kv_v: torch.Tensor, attn_mask: torch.Tensor,
              tp=None) -> torch.Tensor:
    """Attention (einsum + masked f32 softmax) over the updated layer cache,
    o-projection + residual, then the MLP half.  Under ``tp`` (this rank's
    heads and MLP columns) the row-parallel ``o`` and ``down`` products are
    summed in f32 by one all-reduce each (*g*) before the residual, and
    rounded where one device rounds its whole product."""
    B, T, D = x.shape
    H = q.shape[2]
    group = H // kv_k.shape[2]
    kk = kv_k.repeat_interleave(group, dim=2) if group > 1 else kv_k
    vv = kv_v.repeat_interleave(group, dim=2) if group > 1 else kv_v
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(cfg.head_dim)
    logits = logits.masked_fill(~attn_mask[:, None, :, :], torch.finfo(torch.float32).min)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn.float(), vv.float())
    o = o.reshape(B, T, H * cfg.head_dim).to(x.dtype)
    if tp is None:
        x = x + _mm(p["o"], o)
        return x + _mlp(p, rms_norm(p["post_ln"], x, cfg.rms_eps))
    x = x + reduce_from_tp(_mm(p["o"], o, out_dtype=torch.float32), tp).to(x.dtype)
    h = copy_to_tp(rms_norm(p["post_ln"], x, cfg.rms_eps), tp)
    return x + reduce_from_tp(_mlp(p, h, out_dtype=torch.float32), tp).to(x.dtype)


def _lm_head(params: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """f32 logits; under ``tp`` this rank's vocabulary columns, gathered
    along the last dim (every rank then holds all of them)."""
    w = params["lm_head"]
    x = copy_to_tp(x, tp)
    if isinstance(w, dict) and "q" in w:
        return gather_from_tp(_mm(w, x, out_dtype=torch.float32), tp)
    return gather_from_tp(dot_f32(x, w), tp)


def forward(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, write_at: int,
            attn_mask: torch.Tensor, lm_at: Optional[torch.Tensor] = None, tp=None):
    """Decoder stack over ``embeds [B, T, D]``; writes k/v into ``cache`` in
    place at ``write_at`` (an int: slots ``write_at..`` of every row; a
    ``[B]`` long tensor: row b's own slots from ``write_at[b]``) and
    returns ``(logits, cache)``; ``lm_at [B]`` restricts the lm_head to one
    position per row (``[B, 1, V]``).  Under ``tp`` the params and the
    cache are this rank's heads (a cache from :func:`init_cache` of
    ``local_config(cfg, tp)``)."""
    x = embeds
    B, T = x.shape[:2]
    if isinstance(write_at, torch.Tensor):
        at = (torch.arange(B, device=x.device)[:, None],
              write_at[:, None] + torch.arange(T, device=x.device))
    else:
        at = (slice(None), slice(write_at, write_at + T))
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        q, k, v = _qkv(p, cfg, x, positions, tp)
        cache.k[li][at] = k.to(cache.k.dtype)
        cache.v[li][at] = v.to(cache.v.dtype)
        x = _attn_mlp(p, cfg, x, q, cache.k[li], cache.v[li], attn_mask, tp)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    if lm_at is not None:
        x = x[torch.arange(x.shape[0], device=x.device)[:, None], lm_at[:, None]]
    return _lm_head(params, x, tp), cache


def _train_layer(p: Params, cfg: Phi3Config, x: torch.Tensor, positions: torch.Tensor,
                 attn_mask: torch.Tensor, tp=None) -> torch.Tensor:
    q, k, v = _qkv(p, cfg, x, positions, tp)
    return _attn_mlp(p, cfg, x, q, k, v, attn_mask, tp)


def forward_train(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                  positions: torch.Tensor, attn_mask: torch.Tensor,
                  lm_rows: torch.Tensor, tp=None) -> torch.Tensor:
    """The decoder stack for a loss: each layer attends over the sequence's
    own K/V (``forward`` on a fresh cache of length T written at 0, without
    the in-place cache writes) and is recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference
    rematerializes each layer in training.  ``attn_mask [B, T, T]``;
    ``lm_rows [B, R]`` gathers R positions per row before the lm_head, so
    only those rows are projected onto the vocabulary (``[B, R, V]``).
    Under ``tp`` the recompute repeats each layer's two all-reduces in the
    same order on every rank."""
    x = embeds
    for p in params["layers"]:
        x = checkpoint(_train_layer, p, cfg, x, positions, attn_mask, tp, use_reentrant=False)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    x = torch.gather(x, 1, lm_rows[..., None].expand(-1, -1, x.shape[-1]))
    return _lm_head(params, x, tp)


# the decode step over dense / int8 weights is the same stack, with T = the
# number of new tokens and the cache written in place
decode_forward = forward


def embed(params: Params, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """Token embeddings; under ``tp`` the table is this rank's rows of the
    vocabulary: ids outside them read zeros and one all-reduce (in f32,
    exact: one rank's row plus zeros) sums the ranks' rows."""
    table = params["embed_tokens"]
    if tp is None:
        return table[ids]
    n = table.shape[0]
    local = ids - group_rank(tp) * n
    inside = (local >= 0) & (local < n)
    e = table[local.clamp(0, n - 1)].float() * inside[..., None]
    return reduce_from_tp(e, tp, "embed").to(table.dtype)


def local_config(cfg: Phi3Config, tp) -> Phi3Config:
    """``cfg`` with one rank's share of the heads under ``tp`` (for
    :func:`init_cache` and the cache's reshapes)."""
    n = group_size(tp)
    if n == 1:
        return cfg
    if cfg.num_heads % n or cfg.num_kv_heads % n:
        raise ValueError(f"{cfg.num_heads} / {cfg.num_kv_heads} heads do not split {n} ways")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               num_kv_heads=cfg.num_kv_heads // n)


def prefill_mask(attn_valid: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Causal + padding mask ``[B, T]`` -> ``[B, T, cache_len]``."""
    B, T = attn_valid.shape
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=attn_valid.device))
    m = causal[None] & attn_valid[:, None, :] & attn_valid[:, :, None]
    if cache_len > T:
        m = torch.cat([m, torch.zeros(B, T, cache_len - T, dtype=torch.bool,
                                      device=attn_valid.device)], dim=-1)
    return m


def _q4(w):
    return w["q4"] if isinstance(w, dict) and "q4" in w else None


def _pack_route(params: Params, cfg: Phi3Config) -> Optional[str]:
    """What layer 0's packs allow, flags aside: ``"attn"`` where the decode
    kernels' attention takes them (packed int4 qkv / o at unpadded widths,
    MHA), ``"ring"`` where the whole-layer ring does too (int4 MLP packs
    with the attention's block sizes, and the reference ring's prime
    points: >= 3 gate_up and >= 2 qkv column blocks), else ``None``."""
    D = cfg.hidden_size
    if not (cfg.num_heads == cfg.num_kv_heads and cfg.num_heads * cfg.head_dim == D):
        return None
    qkv, o, gu, dn = (_q4(params["layers"][0].get(n)) for n in ("qkv", "o", "gate_up", "down"))
    if not (qkv is not None and o is not None
            and qkv.d == D and qkv.n == 3 * D == 2 * qkv.n2
            and o.d == D and o.n == D == 2 * o.n2 and qkv.dblk == o.dblk):
        return None
    ring = (gu is not None and dn is not None
            and gu.d == D and gu.n == 2 * gu.n2 and dn.n == D == 2 * dn.n2 and gu.n2 == dn.dp
            and gu.dblk == qkv.dblk == dn.dblk and qkv.nblk == o.nblk == gu.nblk == dn.nblk
            and gu.n2 >= 3 * gu.nblk and qkv.n2 >= 2 * qkv.nblk)
    return "ring" if ring else "attn"


def decode_route(params: Params, cfg: Phi3Config, rows: int, tp=None) -> str:
    """How a decode pass of ``rows`` rows runs through the layers, from the
    packs and the decode flags (read at call time):

    * ``"ring"``: ``_ring_stack`` (kernels A and B), at most 8 rows over
      ring packs under ``DYNAM3D_FUSED_RING``;
    * ``"split"``: one row over attention packs, kernel H then G
      (``_decode_forward_split``);
    * ``"wide"``: 9..16 rows over attention packs, A, B in plain mode and F
      (``_decode_forward_wide``);
    * ``"unfused"``: ``forward`` (``int4_matmul`` and ``int4_mlp``):
      ``DYNAM3D_FUSED_ATTN=0``, other weights, more than 16 rows, any
      ``tp``.

    The reference also requires a TPU backend; the port takes the same
    route on either device."""
    packs = _pack_route(params, cfg) if tp is None and flags.fused_attn() else None
    if packs is None:
        return "unfused"
    if rows <= MAX_ROWS and packs == "ring" and flags.fused_ring():
        return "ring"
    if rows == 1:
        return "split"
    return "wide" if MAX_ROWS < rows <= ATTN_ROWS else "unfused"


def _flat(cache: KVCache, cfg: Phi3Config) -> KVCache:
    L, B, T = cache.k.shape[:3]
    return KVCache(cache.k.view(L, B, T, cfg.hidden_size), cache.v.view(L, B, T, cfg.hidden_size))


def _rope_table(cfg: Phi3Config, pos: torch.Tensor):
    ang = pos.to(torch.float32)[:, None] * _freqs(cfg, pos.device)
    return torch.cos(ang), torch.sin(ang)


def _ring_stack(params: Params, cfg: Phi3Config, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, cache: KVCache, t_scan: int, mask: torch.Tensor, group: int,
                rows_of_cache: Optional[torch.Tensor], slots) -> torch.Tensor:
    """The ring's layers, final norm and head over ``x [R, 1, D]`` (R <= 8)
    and the flat ``[L, Bc, Tmax, D]`` cache.  Each layer is
    ``decode_layer_ring`` in mode ``group`` over the first ``t_scan`` cache
    rows under ``mask`` (``[1 or R, Tmax]``, the current slots excluded),
    then row r's new k/v written at slot ``slots[r]`` (or the int
    ``slots``) of cache row ``rows_of_cache[r]`` (``None``: row 0).  No
    host read, so a CUDA graph can capture it.  Returns logits ``[R, 1, V]``."""
    D = x.shape[-1]
    at = slots if rows_of_cache is None else rows_of_cache * cache.k.shape[2] + slots
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        x, k_new, v_new = decode_layer_ring(
            x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
            p["gate_up"]["q4"], p["down"]["q4"], cache.k, cache.v, li, t_scan,
            mask, cos, sin, eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim, group=group,
        )
        cache.k[li].view(-1, D).index_copy_(0, at, k_new.to(cache.k.dtype))
        cache.v[li].view(-1, D).index_copy_(0, at, v_new.to(cache.v.dtype))
    return _lm_head(params, rms_norm(params["final_ln"], x, cfg.rms_eps))


# greedy_decode's passes on the ring, split and wide routes (_FUSED_PASS)
# share the wide route's signature: one token per row (``embeds [B, 1, D]``)
# over the flat ``[L, B, Tmax, D]`` cache, written at ``write_at``;
# ``valid [B, Tmax]`` includes the current slot, which the kernels fold
# themselves.

def _decode_forward_ring(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                         positions: torch.Tensor, cache: KVCache, write_at: int,
                         valid: torch.Tensor):
    """B <= 8 rows on the ring in plain mode (each row its own cache row)."""
    cos, sin = _rope_table(cfg, positions[:, 0])
    mask = valid.clone()
    mask[:, write_at] = False
    rows = torch.arange(embeds.shape[0], device=embeds.device)
    return _ring_stack(params, cfg, embeds, cos, sin, cache,
                       scan_length(write_at, cache.k.shape[2]), mask, 1, rows, write_at), cache


def _decode_forward_split(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                          positions: torch.Tensor, cache: KVCache, write_at: int,
                          valid: torch.Tensor):
    """B = 1 on the split route: ``decode_attn_layer`` then
    ``int4_mlp_block`` per layer, with the residual between the halves in
    bf16."""
    D = cfg.hidden_size
    cos, sin = _rope_table(cfg, positions[:, 0])
    mask = valid.clone()
    mask[:, write_at] = False
    x = embeds
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        x, k_new, v_new = decode_attn_layer(
            x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], cache.k, cache.v, li,
            write_at, mask[0], cos[0], sin[0], eps=cfg.rms_eps,
            heads=cfg.num_heads, hd=cfg.head_dim,
        )
        cache.k[li, :, write_at] = k_new.view(1, D)
        cache.v[li, :, write_at] = v_new.view(1, D)
        x = int4_mlp_block(x, p["post_ln"], p["gate_up"]["q4"], p["down"]["q4"], cfg.rms_eps)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    return _lm_head(params, x), cache


def _decode_forward_wide(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                         positions: torch.Tensor, cache: KVCache, write_at: int,
                         valid: torch.Tensor):
    """One token per row (``embeds [B, 1, D]``, B = 9..16) over the flat
    ``[L, B, Tmax, D]`` cache; ``valid [B, Tmax]`` includes the current slot.

    Each layer: kernel A on qkv (RMSNorm prologue, f32 out), kernel B in
    plain mode over the bf16 cache rows before ``write_at`` (each row folds
    its own new k/v), the new k/v written at ``write_at``, kernel A on o
    with the residual added in f32 and rounded to bf16, then the post-norm,
    ``_mlp`` (kernel F) and the residual.  The head is ``_lm_head``'s."""
    B, _, D = embeds.shape
    cos, sin = _rope_table(cfg, positions[:, 0])
    mask_rows = valid.clone()
    mask_rows[:, write_at] = False          # kernel B folds the current token itself
    x = embeds.reshape(B, D)
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        y = int4_matvec(x, p["qkv"]["q4"], ln_w=p["input_ln"], eps=cfg.rms_eps,
                        out_dtype=torch.float32)
        ctx, k_new, v_new = decode_attn(y, cos, sin, cache.k, cache.v, li, mask_rows, write_at,
                                        1, heads=cfg.num_heads, hd=cfg.head_dim)
        cache.k[li, :, write_at] = k_new
        cache.v[li, :, write_at] = v_new
        x = int4_matvec(ctx, p["o"]["q4"], residual=x, epilogue="residual", out_dtype=x.dtype)
        x = x + _mlp(p, rms_norm(p["post_ln"], x, cfg.rms_eps))
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    return _lm_head(params, x[:, None]), cache


_FUSED_PASS = {"ring": _decode_forward_ring, "split": _decode_forward_split,
               "wide": _decode_forward_wide}


# --------------------------------------------- the B=1 ring pass as a CUDA graph
#
# greedy_decode_spec's B=1 ring passes read everything that changes from pass
# to pass from long-lived tensors: the cache and the accepted-slot mask of
# the call's Tmax, and three rows of MAX_ROWS longs on the device (ids,
# positions, write slots) filled from a host copy before the pass.  On the
# card each (rows, Tmax, t_scan) is captured once as a CUDA graph and then
# replayed; on the CPU the same body runs eagerly.  The buffers of at most
# _TMAX_KEPT cache lengths are kept, the least recently used dropped first
# with the graphs that read them.

class _RingBuffers(NamedTuple):
    cache: KVCache          # [L, 1, Tmax, H, hd], zeroed by each call's prefill
    valid: torch.Tensor     # [1, Tmax] bool: the accepted slots
    inputs: torch.Tensor    # [3, MAX_ROWS] int64: ids, positions, write slots
    staged: torch.Tensor    # its host copy (pinned for a card)


class _Graph(NamedTuple):
    graph: Any              # torch.cuda.CUDAGraph
    out: tuple              # (logits [1, r, V], argmax [r]), rewritten by each replay
    launches: Dict[str, int]    # kernel launches a replay makes
    reads: tuple            # what it reads by address besides the weights: its
                            # _RingBuffers, then the ticket buffers it was captured on


# the ring's buffers and graphs serve one call at a time (run_interleaved
# decodes from threads)
_ring_lock = threading.Lock()
_ring_buffers: Dict[tuple, _RingBuffers] = {}
_graphs: Dict[tuple, _Graph] = {}
_graphs_owner: Optional[tuple] = None
_TMAX_KEPT = 3


def _buffers(cfg: Phi3Config, tmax: int, dtype: torch.dtype, device: torch.device) -> _RingBuffers:
    """The ring's buffers of one cache length, made at its first call;
    ``_ring_buffers`` runs from the least to the most recently used."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, dtype, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, tmax)
    buf = _ring_buffers.pop(key, None)
    if buf is None:
        while len(_ring_buffers) >= _TMAX_KEPT:
            old = _ring_buffers.pop(next(iter(_ring_buffers)))
            for gk in [gk for gk, g in _graphs.items() if g.reads[0] is old]:
                del _graphs[gk]
        inputs = torch.zeros((3, MAX_ROWS), dtype=torch.int64, device=device)
        buf = _RingBuffers(
            init_cache(cfg, 1, tmax, dtype=dtype, device=device),
            torch.zeros((1, tmax), dtype=torch.bool, device=device), inputs,
            torch.zeros_like(inputs, device="cpu", pin_memory=device.type == "cuda"))
    _ring_buffers[key] = buf
    return buf


def _claim_graphs(params: Params, cfg: Phi3Config, dtype: torch.dtype) -> None:
    """Drop the graphs unless they were captured on these weights."""
    global _graphs_owner
    owner = _graph_owner(params, cfg, dtype)
    if owner != _graphs_owner:
        _graphs.clear()
        _graphs_owner = owner


def _graph_key(rows: int, tmax: int, wslot: int) -> Tuple[int, int, int]:
    """``(rows, Tmax, t_scan)``: what a captured pass depends on besides its
    buffers and weights."""
    return rows, tmax, scan_length(wslot, tmax)


def _graph_owner(params: Params, cfg: Phi3Config, dtype: torch.dtype) -> tuple:
    """What the graphs bake in besides the buffers: the address of every
    weight tensor and each int4 pack's shape and group size (the other
    shapes follow from the configuration), the configuration, the cache's
    dtype and the head's matvec flag.  Graphs of another owner are dropped."""
    ptrs = []

    def walk(w):
        if isinstance(w, torch.Tensor):
            ptrs.append(w.data_ptr())
        elif isinstance(w, dict):
            for v in w.values():
                walk(v)
        elif isinstance(w, list):
            for v in w:
                walk(v)
        elif w is not None:                     # Int4Weight
            ptrs.extend((w.q4.data_ptr(), w.s_lo.data_ptr(), w.s_hi.data_ptr(), w.q4.shape,
                         w.dblk))

    walk([params[n] for n in ("embed_tokens", "layers", "final_ln", "lm_head")])
    return tuple(ptrs), cfg, dtype, flags.int4_grid2d()


def _ring_body(params: Params, cfg: Phi3Config, buf: _RingBuffers, rows: int, t_scan: int):
    """One pass over the buffers: ``rows`` ids at their positions, written
    at their slots of cache row 0, the rows sharing it (``group = rows``:
    row j folds rows 0..j).  Returns ``(logits [1, rows, V], argmax [rows])``."""
    ids, pos, slots = buf.inputs[:, :rows]
    x = embed(params, ids).to(buf.cache.k.dtype)[:, None, :]
    cos, sin = _rope_table(cfg, pos)
    logits = _ring_stack(params, cfg, x, cos, sin, _flat(buf.cache, cfg), t_scan, buf.valid,
                         rows, None, slots).view(1, rows, -1)
    return logits, logits[0].argmax(-1)


def _ring_pass(params: Params, cfg: Phi3Config, buf: _RingBuffers, ids: np.ndarray,
               pos0: int, wslot: int):
    """Stage a pass's ids, positions and slots and run it: eagerly on the
    CPU, on the card as the replay of its key's graph (captured at the key's
    first pass over these buffers).  Returns the body's ``(logits, argmax)``."""
    rows = len(ids)
    key = _graph_key(rows, buf.valid.shape[1], wslot)
    st = buf.staged.numpy()
    st[0, :rows] = ids
    st[1, :rows] = pos0 + np.arange(rows)
    st[2, :rows] = wslot + np.arange(rows)
    buf.inputs.copy_(buf.staged, non_blocking=True)
    if not buf.valid.is_cuda:
        return _ring_body(params, cfg, buf, rows, key[2])
    g = _graphs.get(key)
    if g is None or g.reads[0] is not buf:
        g = _graphs[key] = _capture(lambda: _ring_body(params, cfg, buf, rows, key[2]), buf)
        profiling.count("decode.graph_captures")
    g.graph.replay()
    for name, n in g.launches.items():
        kernels.count(kernels.launches, name, n)
    profiling.count("decode.graph_replays")
    return g.out


def _capture(body, buf: _RingBuffers) -> _Graph:
    """Run ``body`` once eagerly on a side stream (the launch plans, ticket
    buffers and the kernels' one-time attribute calls happen there), then
    capture it.  The capture launches nothing: the launches it tallied are
    taken back off ``kernels.launches`` and added at each replay.  The graph
    holds the ticket buffers it was captured on, which a larger request
    elsewhere may replace (each launch leaves its tickets zero, so a held
    buffer stays ready for the replays)."""
    device = buf.valid.device
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
        before = dict(kernels.launches)
        tickets = int4._tickets.get(device)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = body()
        finally:
            graph.capture_end()
        tickets = (tickets, int4._tickets.get(device))
        tally = {n: v - before[n] for n, v in kernels.launches.items() if v != before[n]}
        for name, n in tally.items():
            kernels.count(kernels.launches, name, -n)
    cur.wait_stream(side)
    return _Graph(graph, out, tally, (buf,) + tickets)


def _last_valid_idx(attn_valid: torch.Tensor) -> torch.Tensor:
    """PHYSICAL index of each row's last valid token (not the count: the
    prompt has masked interior slots)."""
    T = attn_valid.shape[1]
    return T - 1 - torch.argmax(attn_valid.flip(1).to(torch.int32), dim=1)


def _prefill(params, cfg, embeds, attn_valid, total, tp=None, cache=None):
    """The prompt's pass into a fresh cache of ``total`` rows, or into
    ``cache`` zeroed first; returns the first token and the cache."""
    if cache is None:
        cache = init_cache(local_config(cfg, tp), embeds.shape[0], total, dtype=embeds.dtype,
                           device=embeds.device)
    else:
        cache.k.zero_()
        cache.v.zero_()
    positions = torch.clamp(torch.cumsum(attn_valid.to(torch.int64), 1) - 1, min=0)
    mask = prefill_mask(attn_valid, total)
    logits, cache = forward(params, cfg, embeds, positions, cache, 0, mask,
                            lm_at=_last_valid_idx(attn_valid), tp=tp)
    return logits[:, 0].argmax(-1), cache


def greedy_decode(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                  attn_valid: torch.Tensor, max_new_tokens: int,
                  stop_token: Optional[int] = None, tp=None) -> torch.Tensor:
    """Greedy generation over right-padded prompts on the batch's
    :func:`decode_route`; returns ``[B, max_new]`` ids (stop token
    included, pad after it).  Under ``tp`` (params sharded by
    ``parallel.shard_tree``, ``embeds`` whole on every rank) each pass
    makes two all-reduces a layer, one for the next token's embedding and
    one gather of the logits, and every rank returns the same ids; the
    fused kernels never run there."""
    B, T, D = embeds.shape
    route = decode_route(params, cfg, B, tp)
    total = T + max_new_tokens
    if route in ("ring", "split"):
        total = -(-total // ROWS) * ROWS
    stop = cfg.end_token_id if stop_token is None else stop_token
    dev = embeds.device

    def more(i):
        if i >= max_new_tokens:
            return False
        profiling.count("sync")
        return not bool((done | (tok == stop)).all())

    with profiling.span("generate.prefill"):
        tok, cache = _prefill(params, cfg, embeds, attn_valid, total, tp)
        if route != "unfused":
            cache = _flat(cache, cfg)
        out = torch.full((B, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=dev)
        done = tok == stop
        valid = torch.cat([attn_valid, torch.zeros(B, total - T, dtype=torch.bool, device=dev)],
                          1)
        valid[:, T] = True
        i = 0
        going = more(i)
    while going:
        with profiling.span("generate.pass"):
            out[:, i] = torch.where(done, cfg.pad_token_id, tok)
            e = embed(params, tok, tp)[:, None, :].to(embeds.dtype)
            pos = (valid.sum(1) - 1)[:, None]
            if route == "unfused":
                logits, cache = decode_forward(params, cfg, e, pos, cache, T + i,
                                               valid[:, None, :], tp=tp)
            else:
                logits, cache = _FUSED_PASS[route](params, cfg, e, pos, cache, T + i, valid)
            if route == "wide":
                profiling.count("decode.wide_passes")
            nxt = logits[:, 0].argmax(-1)
            done = done | (tok == stop)
            nxt = torch.where(done, stop, nxt)
            if T + i + 1 < total:
                valid[:, T + i + 1] = True
            tok = nxt
            i += 1
            profiling.count("decode.passes")
            going = more(i)
    if i < max_new_tokens:
        out[:, i] = torch.where(done, out[:, i], tok)
    return out


def _ngram_draft(hist: np.ndarray, n_hist: int, prev3: int, prev2: int, prev: int,
                 last: int, k: int) -> np.ndarray:
    """Prompt-lookup draft: the ``k-1`` tokens that followed the most recent
    EARLIER occurrence of the longest matching n-gram (4-gram -> trigram ->
    bigram -> unigram) in ``hist``; all -1 when none occurs."""
    Lh = hist.shape[0]
    idx = np.arange(Lh - 1)
    a0, a1 = hist[:-1], hist[1:]
    live = (a1 >= 0) & (idx + 1 < n_hist - 1)
    am1 = np.concatenate([np.full(1, -9, hist.dtype), hist[:-2]])
    am2 = np.concatenate([np.full(2, -9, hist.dtype), hist[:-3]])
    quad = ((am2 == prev3) & (am1 == prev2) & (a0 == prev) & (a1 == last)
            & (am2 >= 0) & (am1 >= 0) & (a0 >= 0) & live
            & (prev3 >= 0) & (prev2 >= 0) & (prev >= 0))
    tri = ((am1 == prev2) & (a0 == prev) & (a1 == last) & (am1 >= 0) & (a0 >= 0)
           & live & (prev2 >= 0) & (prev >= 0))
    bi = (a0 == prev) & (a1 == last) & (a0 >= 0) & live & (prev >= 0)
    uni = (a1 == last) & live
    m = quad if quad.any() else tri if tri.any() else bi if bi.any() else uni
    if not m.any():
        return np.full(k - 1, -1, hist.dtype)
    p = int(idx[m].max())
    start = min(max(p + 2, 0), Lh - (k - 1))
    return hist[start: start + k - 1].copy()


def greedy_decode_spec(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                       attn_valid: torch.Tensor, max_new_tokens: int,
                       stop_token: Optional[int] = None,
                       lookup_ids: Optional[torch.Tensor] = None,
                       draft_len: Optional[int] = None,
                       stats: Optional[dict] = None) -> torch.Tensor:
    """Speculative greedy decode of B = 1..4 episodes with n-gram
    prompt-lookup drafts seeded by ``lookup_ids [B, S]`` (-1 never matches).

    A pass verifies ``g`` rows an episode, the carried token and its draft:
    ``g = min(draft_len, 8 // B)`` (``draft_len`` defaults to
    ``flags.SPEC_DRAFT_LEN``), so one weight stream verifies up to ``g``
    tokens for every episode; at B=1 a pass without a draft runs one row.
    Greedy-exact row by row: a draft token is accepted only when the pass's
    own argmax at the previous position equals it, so the ids equal
    :func:`greedy_decode`'s; rows accept and stop independently and
    finished rows coast.  ``stats`` (if given) receives ``tokens`` (an int
    at B=1, per row otherwise) and ``passes``.  Under
    ``flags.spec_force_accept()`` every pass verifies and accepts all ``g``
    rows (timing only).

    Where :func:`decode_route` gives ``"ring"`` for ``B * g`` rows, B=1 runs
    every pass over long-lived buffers of the call's cache length
    (``_ring_pass``: replayed as a CUDA graph on the card, counted as
    ``decode.graph_replays`` and ``decode.graph_captures``) and B >= 2 runs
    ``_ring_stack`` in grouped mode; otherwise each pass is ``forward``
    writing every episode's rows at its own slots."""
    B = embeds.shape[0]
    if not 1 <= B <= MAX_ROWS // 2:
        raise ValueError(f"speculative decode takes 1..{MAX_ROWS // 2} episodes, not {B}")
    # only B=1 runs on the ring's shared buffers; B >= 2 calls run concurrently
    with _ring_lock if B == 1 else contextlib.nullcontext():
        return _greedy_decode_spec(params, cfg, embeds, attn_valid, max_new_tokens, stop_token,
                                   lookup_ids, draft_len, stats)


def _greedy_decode_spec(params, cfg, embeds, attn_valid, max_new_tokens, stop_token,
                        lookup_ids, draft_len, stats):
    B, T, D = embeds.shape
    g = max(2, min(int(draft_len or flags.SPEC_DRAFT_LEN), max_new_tokens, MAX_ROWS // B))
    ring = decode_route(params, cfg, B * g) == "ring"
    total = T + max_new_tokens + g
    dev = embeds.device
    buf = None
    if ring:
        total = -(-total // ROWS) * ROWS
    if ring and B == 1:
        buf = _buffers(cfg, total, embeds.dtype, dev)
        if dev.type == "cuda":
            _claim_graphs(params, cfg, embeds.dtype)
    with profiling.span("generate.prefill"):
        first, cache = _prefill(params, cfg, embeds, attn_valid, total,
                                cache=None if buf is None else buf.cache)
        if ring:
            cache = _flat(cache, cfg)
        stop = cfg.end_token_id if stop_token is None else stop_token
        profiling.count("sync")
        first = first.cpu().numpy().astype(np.int64)

        S = 0 if lookup_ids is None else int(lookup_ids.shape[-1])
        hist = np.full((B, S + max_new_tokens + g + 2), -1, np.int64)
        if lookup_ids is not None:
            profiling.count("sync")
            hist[:, :S] = lookup_ids.reshape(B, S).to("cpu", torch.int64).numpy()
        hist[:, S] = first
        profiling.count("sync")
        n_pos0 = attn_valid.sum(1).cpu().numpy().astype(np.int64)
    out = np.full((B, max_new_tokens), cfg.pad_token_id, np.int64)
    out[:, 0] = first
    if buf is None:
        valid = torch.cat([attn_valid, torch.zeros(B, total - T, dtype=torch.bool, device=dev)],
                          1)
    else:
        valid = buf.valid
        valid.zero_()
        valid[:, :T] = attn_valid
    t_iota = torch.arange(total, device=dev)
    gg = np.arange(g)
    n_em = np.ones(B, np.int64)
    done = (first == stop).tolist()
    last, prev, prev2 = first.tolist(), [-1] * B, [-1] * B
    npass = 0
    force = flags.spec_force_accept()
    while any(not done[b] and n_em[b] < max_new_tokens for b in range(B)):
        with profiling.span("generate.pass"):
            d = np.empty((B, g), np.int64)                     # the carried token, its draft
            for b in range(B):
                b3 = S + n_em[b] - 4
                prev3 = int(hist[b, b3]) if b3 >= 0 else -1
                d[b, 0] = last[b]
                d[b, 1:] = _ngram_draft(hist[b], int(S + n_em[b]), prev3, prev2[b], prev[b],
                                        last[b], g)
            r = g if B > 1 or force or (d[:, 1:] >= 0).any() else 1      # rows an episode
            ids = np.clip(d[:, :r], 0, None)
            pos0, wslot = n_pos0 + n_em - 1, T + n_em - 1
            if buf is not None:
                top = _ring_pass(params, cfg, buf, ids[0], int(pos0[0]), int(wslot[0]))[1]
            else:
                e = embed(params, torch.as_tensor(ids, device=dev)).to(embeds.dtype)
                pos = torch.as_tensor(pos0[:, None] + gg[:r], device=dev)       # [B, r]
                if ring:
                    cos, sin = _rope_table(cfg, pos.reshape(-1))
                    slots = torch.as_tensor((wslot[:, None] + gg).reshape(-1), device=dev)
                    rows = torch.arange(B, device=dev).repeat_interleave(g)
                    lg = _ring_stack(params, cfg, e.reshape(B * g, 1, D), cos, sin, cache,
                                     scan_length(wslot.max(), total),
                                     valid.repeat_interleave(g, dim=0), g, rows, slots)
                else:
                    ws = torch.as_tensor(wslot, device=dev)
                    w3 = ws[:, None, None]
                    extra = (t_iota >= w3) & (t_iota <= w3 + torch.arange(r, device=dev)[:, None])
                    lg, cache = forward(params, cfg, e, pos, cache, ws, valid[:, None, :] | extra)
                top = lg.argmax(-1)
            profiling.count("sync")
            a = top.reshape(B, r).tolist()
            for b in range(B):
                n, w = int(n_em[b]), int(wslot[b])
                if done[b] or n >= max_new_tokens:
                    continue                                   # a finished row coasts
                ab = a[b] + [-2] * (g - r)                     # -2 never matches
                acc = g if force else 1
                while acc < g and d[b, acc] == ab[acc - 1]:
                    acc += 1
                stop_pos = next((j for j in range(acc) if ab[j] == stop), g)
                acc = min(acc, stop_pos + 1, max_new_tokens - n)
                out[b, n: n + acc] = ab[:acc]
                hist[b, S + n: S + n + acc] = ab[:acc]
                valid[b, w: w + acc] = True
                prev2[b] = ab[acc - 3] if acc >= 3 else (last[b] if acc == 2 else prev[b])
                prev[b] = ab[acc - 2] if acc >= 2 else last[b]
                last[b] = ab[acc - 1]
                done[b] = stop_pos < acc
                n_em[b] += acc
            npass += 1
            profiling.count("decode.passes")
    if stats is not None:
        stats.update(tokens=int(n_em[0]) if B == 1 else n_em.tolist(), passes=npass)
    return torch.as_tensor(out, device=dev)


def init_phi3_params(gen: torch.Generator, cfg: Phi3Config, dtype=torch.bfloat16,
                     device=None) -> Params:
    """Random Phi-3 parameters (normal, std 0.02), made on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    D = cfg.hidden_size
    q_sz = cfg.num_heads * cfg.head_dim
    kv_sz = cfg.num_kv_heads * cfg.head_dim

    def dense(d_in, d_out):
        return (torch.randn(d_in, d_out, generator=gen, device=device) * 0.02).to(dtype)

    def ones():
        return torch.ones(D, device=device)

    return {
        "embed_tokens": dense(cfg.vocab_size, D),
        "layers": [
            {
                "input_ln": ones(),
                "qkv": dense(D, q_sz + 2 * kv_sz),
                "o": dense(q_sz, D),
                "post_ln": ones(),
                "gate_up": dense(D, 2 * cfg.intermediate_size),
                "down": dense(cfg.intermediate_size, D),
            }
            for _ in range(cfg.num_layers)
        ],
        "final_ln": ones(),
        "lm_head": dense(D, cfg.vocab_size),
    }


def quantize_phi3(params: Params, bits: int = 8, consume: bool = False) -> Params:
    """Dense Phi-3 params -> int8 ``{q, s}`` (per-column max/127 scales) plus,
    with ``bits=4``, the packed int4 copy ``q4`` (1024-row groups, 512-wide
    column blocks).  ``consume=True`` drops each source weight once its
    quantized form exists.  Norms and embeddings stay as they are."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def q(w):
        wf = w.to(torch.float32)
        scale = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / 127.0, min=1e-8)
        qi = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        # stored column-major: for a column-major second operand
        # torch._int_mm picks an int8 mma tensor-core GEMM, for a row-major
        # one a much slower wmma kernel (see the prefill GEMM in PERF.md)
        out = {"q": qi.t().contiguous().t(), "s": scale}
        if bits == 4:
            out["q4"] = pack_int4(wf, nblk=512)
        return out

    def q_weight(d, name):
        out = q(d[name])
        if consume:
            del d[name]
        return out

    layers: List[Params] = []
    for lp in params["layers"]:
        layers.append({
            "input_ln": lp["input_ln"],
            "qkv": q_weight(lp, "qkv"),
            "o": q_weight(lp, "o"),
            "post_ln": lp["post_ln"],
            "gate_up": q_weight(lp, "gate_up"),
            "down": q_weight(lp, "down"),
        })
    return {
        "embed_tokens": params["embed_tokens"],
        "layers": layers,
        "final_ln": params["final_ln"],
        "lm_head": q_weight(params, "lm_head"),
    }

