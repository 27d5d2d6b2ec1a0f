"""Phi-3-mini decoder with KV-cache prefill and (speculative) greedy decode.

Port of ``models/vlm/phi3.py``: ``rms_norm``, ``_rope``,
``init_cache``, ``forward`` (with ``lm_at``), the training forward
``forward_train``, the weight-format dispatch
``_mm`` (dense, int8 W8A8 prefill, int4 matvec) and ``_mlp`` (fused int4
MLP), ``_lm_head``, ``decode_forward``, the route checks
``_fused_decode_eligible`` / ``_ring_eligible`` / ``_fused_layer_eligible``,
``_decode_forward_fused`` (ring and split), ``_verify_forward_fused``,
``_verify_forward_grouped``, ``_last_valid_idx``, ``_ngram_draft``,
``greedy_decode``, ``greedy_decode_spec``, ``greedy_decode_spec_batched``,
``init_phi3_params`` and ``quantize_phi3``.

Int4 decode takes the reference's routes, chosen by batch, packing and the
decode flags (read at call time), the same on either device:

* the ring (``ops.decode.decode_layer_ring``, kernels B + 4 x A) for B <= 8
  rows, B=1 speculative verify and the grouped B=2..4 verify;
* the split route at B=1 with ``DYNAM3D_FUSED_RING=0``: kernel H
  (``decode_attn_layer``) then kernel G (``int4_mlp_block``) per layer;
* otherwise the unfused ``decode_forward``: ``int4_matmul`` (kernel A, or
  E under ``DYNAM3D_INT4_GRID2D``) and ``int4_mlp`` (kernel F).

Kernels run on CUDA tensors, their plain versions on CPU tensors.  The
decode loops run on the host (Python control flow), reading the argmax of
each pass back from the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dynam3d_torch import flags
from dynam3d_torch.config import Phi3Config
from dynam3d_torch.device import resolve_device
from dynam3d_torch.ops.decode import MAX_ROWS, ROWS, decode_attn_layer, decode_layer_ring
from dynam3d_torch.ops.int4 import int4_matmul, int4_mlp, int4_mlp_block, pack_int4
from dynam3d_torch.ops.transformer import dot_f32

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


def _mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; decode-regime int4 weights go through :func:`int4_mlp`
    (gate and up in f32, h rounded once), others through two ``_mm``."""
    gu, dn = p["gate_up"], p["down"]
    if (isinstance(gu, dict) and "q4" in gu and isinstance(dn, dict) and "q4" in dn
            and _rows(h) <= 16 and flags.int4_fused_mlp()):
        return int4_mlp(h, gu["q4"], dn["q4"], out_dtype=h.dtype)
    gate_up = _mm(gu, h)
    gate, up = gate_up.chunk(2, dim=-1)
    return _mm(dn, torch.nn.functional.silu(gate) * up)


def _qkv(p: Params, cfg: Phi3Config, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    H, hd, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    h = rms_norm(p["input_ln"], x, cfg.rms_eps)
    qkv = _mm(p["qkv"], h)
    q_sz, kv_sz = H * hd, Hkv * hd
    q = qkv[..., :q_sz].reshape(B, T, H, hd)
    k = qkv[..., q_sz: q_sz + kv_sz].reshape(B, T, Hkv, hd)
    v = qkv[..., q_sz + kv_sz:].reshape(B, T, Hkv, hd)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _attn_mlp(p: Params, cfg: Phi3Config, x: torch.Tensor, q: torch.Tensor,
              kv_k: torch.Tensor, kv_v: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """Attention (einsum + masked f32 softmax) over the updated layer cache,
    o-projection + residual, then the MLP half."""
    B, T, D = x.shape
    group = cfg.num_heads // cfg.num_kv_heads
    kk = kv_k.repeat_interleave(group, dim=2) if group > 1 else kv_k
    vv = kv_v.repeat_interleave(group, dim=2) if group > 1 else kv_v
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(cfg.head_dim)
    logits = logits.masked_fill(~attn_mask[:, None, :, :], torch.finfo(torch.float32).min)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn.float(), vv.float())
    o = o.reshape(B, T, cfg.num_heads * cfg.head_dim).to(x.dtype)
    x = x + _mm(p["o"], o)
    h = rms_norm(p["post_ln"], x, cfg.rms_eps)
    return x + _mlp(p, h)


def _lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    w = params["lm_head"]
    if isinstance(w, dict) and "q" in w:
        return _mm(w, x, out_dtype=torch.float32)
    return dot_f32(x, w)


def forward(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, write_at: int,
            attn_mask: torch.Tensor, lm_at: Optional[torch.Tensor] = None):
    """Decoder stack over ``embeds [B, T, D]``; writes k/v into ``cache`` at
    ``write_at`` (in place) and returns ``(logits, cache)``; ``lm_at [B]``
    restricts the lm_head to one position per row (``[B, 1, V]``)."""
    x = embeds
    T = x.shape[1]
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        q, k, v = _qkv(p, cfg, x, positions)
        cache.k[li][:, write_at: write_at + T] = k
        cache.v[li][:, write_at: write_at + T] = v
        x = _attn_mlp(p, cfg, x, q, cache.k[li], cache.v[li], attn_mask)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    if lm_at is not None:
        x = x[torch.arange(x.shape[0], device=x.device)[:, None], lm_at[:, None]]
    return _lm_head(params, x), cache


def _train_layer(p: Params, cfg: Phi3Config, x: torch.Tensor, positions: torch.Tensor,
                 attn_mask: torch.Tensor) -> torch.Tensor:
    q, k, v = _qkv(p, cfg, x, positions)
    return _attn_mlp(p, cfg, x, q, k, v, attn_mask)


def forward_train(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                  positions: torch.Tensor, attn_mask: torch.Tensor,
                  lm_rows: torch.Tensor) -> torch.Tensor:
    """The decoder stack for a loss: each layer attends over the sequence's
    own K/V (``forward`` on a fresh cache of length T written at 0, without
    the in-place cache writes) and is recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference
    rematerializes each layer in training.  ``attn_mask [B, T, T]``;
    ``lm_rows [B, R]`` gathers R positions per row before the lm_head, so
    only those rows are projected onto the vocabulary (``[B, R, V]``)."""
    x = embeds
    for p in params["layers"]:
        x = checkpoint(_train_layer, p, cfg, x, positions, attn_mask, use_reentrant=False)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    x = torch.gather(x, 1, lm_rows[..., None].expand(-1, -1, x.shape[-1]))
    return _lm_head(params, x)


# the decode step over dense / int8 weights is the same stack, with T = the
# number of new tokens and the cache written in place
decode_forward = forward


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids]


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


def _fused_decode_eligible(params: Params, cfg: Phi3Config, batch: int) -> bool:
    """The fused decode kernels take low-batch decode over packed int4
    qkv/o at unpadded widths and MHA: B = 1 on either fused route, B <= 8
    on the ring.  (The reference also requires a TPU backend; the port
    takes the same route on either device.)"""
    max_b = MAX_ROWS if flags.fused_ring() else 1
    if not (flags.fused_attn() and 1 <= batch <= max_b
            and cfg.num_heads == cfg.num_kv_heads
            and cfg.num_heads * cfg.head_dim == cfg.hidden_size):
        return False
    p0 = params["layers"][0]
    qkv, o = _q4(p0.get("qkv")), _q4(p0.get("o"))
    D = cfg.hidden_size
    base = (qkv is not None and o is not None
            and qkv.d == D and qkv.n == 3 * D == 2 * qkv.n2
            and o.d == D and o.n == D == 2 * o.n2
            and qkv.dblk == o.dblk)
    if base and batch > 1:
        return _ring_eligible(params, cfg)
    return base


def _ring_eligible(params: Params, cfg: Phi3Config) -> bool:
    """The ring flag, the structural check, and the reference ring's
    prime points (>= 3 gate_up and >= 2 qkv column blocks)."""
    if not (flags.fused_ring() and _fused_layer_eligible(params, cfg)):
        return False
    p0 = params["layers"][0]
    qkv, gu = p0["qkv"]["q4"], p0["gate_up"]["q4"]
    return gu.n2 >= 3 * gu.nblk and qkv.n2 >= 2 * qkv.nblk


def _fused_layer_eligible(params: Params, cfg: Phi3Config) -> bool:
    """Structural eligibility of the whole-layer ring: the MLP weights are
    packed int4 with the attention weights' block sizes."""
    p0 = params["layers"][0]
    qkv, o = _q4(p0.get("qkv")), _q4(p0.get("o"))
    gu, dn = _q4(p0.get("gate_up")), _q4(p0.get("down"))
    D = cfg.hidden_size
    return (qkv is not None and o is not None and gu is not None and dn is not None
            and gu.d == D and gu.n == 2 * gu.n2
            and dn.n == D == 2 * dn.n2
            and gu.n2 == dn.dp
            and gu.dblk == qkv.dblk == dn.dblk
            and qkv.nblk == o.nblk == gu.nblk == dn.nblk)


def _flat(cache: KVCache, cfg: Phi3Config) -> KVCache:
    L, B, T = cache.k.shape[:3]
    return KVCache(cache.k.view(L, B, T, cfg.hidden_size), cache.v.view(L, B, T, cfg.hidden_size))


def _rope_table(cfg: Phi3Config, pos: torch.Tensor):
    ang = pos.to(torch.float32)[:, None] * _freqs(cfg, pos.device)
    return torch.cos(ang), torch.sin(ang)


def _decode_forward_fused(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                          positions: torch.Tensor, cache: KVCache, write_at: int,
                          valid: torch.Tensor):
    """One token per row (``embeds [B, 1, D]``) over the flat
    ``[L, B, Tmax, D]`` cache; ``valid [B, Tmax]`` includes the current slot.

    Ring-eligible weights run ``decode_layer_ring`` in plain mode (B <= 8).
    Otherwise (B = 1) the split route: ``decode_attn_layer`` then
    ``int4_mlp_block``, with the residual between the halves in bf16."""
    B = embeds.shape[0]
    D = cfg.hidden_size
    cos, sin = _rope_table(cfg, positions[:, 0])
    mask_rows = valid.clone()
    mask_rows[:, write_at] = False          # the kernels fold the current token themselves
    use_ring = _ring_eligible(params, cfg)
    if not use_ring and B != 1:
        raise ValueError("B > 1 fused decode requires the ring")
    x = embeds
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        if use_ring:
            x, k_new, v_new = decode_layer_ring(
                x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
                p["gate_up"]["q4"], p["down"]["q4"], cache.k, cache.v, li, write_at,
                mask_rows, cos, sin, eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim,
            )
        else:
            x, k_new, v_new = decode_attn_layer(
                x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], cache.k, cache.v, li,
                write_at, mask_rows[0], cos[0], sin[0], eps=cfg.rms_eps,
                heads=cfg.num_heads, hd=cfg.head_dim,
            )
        cache.k[li, :, write_at] = k_new.view(B, D)
        cache.v[li, :, write_at] = v_new.view(B, D)
        if not use_ring:
            x = int4_mlp_block(x, p["post_ln"], p["gate_up"]["q4"], p["down"]["q4"],
                               cfg.rms_eps)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    return _lm_head(params, x), cache


def _verify_forward_fused(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                          pos0: int, cache: KVCache, wslot: int, valid: torch.Tensor):
    """Speculative verify pass: ``embeds [1, k, D]`` draft rows share one
    weight stream and one cache row (shared-cache mode); row r folds draft
    rows 0..r.  ``valid [1, Tmax]`` holds the ACCEPTED slots only.  Writes
    the drafts' k/v at ``wslot..wslot+k-1`` and returns logits ``[1, k, V]``."""
    _, k, D = embeds.shape
    cos, sin = _rope_table(cfg, pos0 + torch.arange(k, device=embeds.device))
    x = embeds[0][:, None, :]
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        x, k_new, v_new = decode_layer_ring(
            x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
            p["gate_up"]["q4"], p["down"]["q4"], cache.k, cache.v, li, wslot,
            valid, cos, sin, eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim,
            shared_cache=True,
        )
        cache.k[li, 0, wslot: wslot + k] = k_new
        cache.v[li, 0, wslot: wslot + k] = v_new
    x = rms_norm(params["final_ln"], x.reshape(1, k, D), cfg.rms_eps)
    return _lm_head(params, x), cache


def _last_valid_idx(attn_valid: torch.Tensor) -> torch.Tensor:
    """PHYSICAL index of each row's last valid token (not the count: the
    prompt has masked interior slots)."""
    T = attn_valid.shape[1]
    return T - 1 - torch.argmax(attn_valid.flip(1).to(torch.int32), dim=1)


def _prefill(params, cfg, embeds, attn_valid, total):
    cache = init_cache(cfg, embeds.shape[0], total, dtype=embeds.dtype, device=embeds.device)
    positions = torch.clamp(torch.cumsum(attn_valid.to(torch.int64), 1) - 1, min=0)
    mask = prefill_mask(attn_valid, total)
    logits, cache = forward(params, cfg, embeds, positions, cache, 0, mask,
                            lm_at=_last_valid_idx(attn_valid))
    return logits[:, 0].argmax(-1), cache


def greedy_decode(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                  attn_valid: torch.Tensor, max_new_tokens: int,
                  stop_token: Optional[int] = None) -> torch.Tensor:
    """Greedy generation over right-padded prompts; returns ``[B, max_new]``
    ids (stop token included, pad after it)."""
    B, T, D = embeds.shape
    fused = _fused_decode_eligible(params, cfg, B)
    total = T + max_new_tokens
    if fused:
        total = -(-total // ROWS) * ROWS
    tok, cache = _prefill(params, cfg, embeds, attn_valid, total)
    if fused:
        cache = _flat(cache, cfg)
    stop = cfg.end_token_id if stop_token is None else stop_token
    dev = embeds.device
    out = torch.full((B, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=dev)
    done = tok == stop
    valid = torch.cat([attn_valid, torch.zeros(B, total - T, dtype=torch.bool, device=dev)], 1)
    valid[:, T] = True
    i = 0
    while i < max_new_tokens and not bool((done | (tok == stop)).all()):
        out[:, i] = torch.where(done, cfg.pad_token_id, tok)
        e = embed(params, tok)[:, None, :].to(embeds.dtype)
        pos = (valid.sum(1) - 1)[:, None]
        if fused:
            logits, cache = _decode_forward_fused(params, cfg, e, pos, cache, T + i, valid)
        else:
            logits, cache = decode_forward(params, cfg, e, pos, cache, T + i, valid[:, None, :])
        nxt = logits[:, 0].argmax(-1)
        done = done | (tok == stop)
        nxt = torch.where(done, stop, nxt)
        if T + i + 1 < total:
            valid[:, T + i + 1] = True
        tok = nxt
        i += 1
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
    """Speculative greedy decode at B=1 with n-gram prompt-lookup drafts.

    Greedy-exact: a draft token is accepted only when the pass's own argmax
    at the previous position equals it, so the ids equal
    :func:`greedy_decode`'s.  A pass without a draft runs a plain one-token
    step.  ``stats`` (if given) receives ``tokens`` and ``passes``."""
    B, T, D = embeds.shape
    if B != 1:
        raise ValueError("speculative decode is a B=1 serving path")
    k = int(draft_len or flags.SPEC_DRAFT_LEN)
    k = max(2, min(k, max_new_tokens, 8))
    fused = _fused_decode_eligible(params, cfg, 1) and _ring_eligible(params, cfg)
    total = T + max_new_tokens + k
    if fused:
        total = -(-total // ROWS) * ROWS
    first, cache = _prefill(params, cfg, embeds, attn_valid, total)
    if fused:
        cache = _flat(cache, cfg)
    stop = cfg.end_token_id if stop_token is None else stop_token
    dev = embeds.device
    next_tok = int(first[0])

    lk = np.zeros(0, np.int64) if lookup_ids is None else \
        lookup_ids.reshape(-1).to("cpu", torch.int64).numpy()
    S = lk.shape[0]
    hist = np.full(S + max_new_tokens + k + 2, -1, np.int64)
    hist[:S] = lk
    hist[S] = next_tok
    n_pos0 = int(attn_valid.sum())
    out = np.full(max_new_tokens, cfg.pad_token_id, np.int64)
    out[0] = next_tok
    done = next_tok == stop
    valid = torch.cat([attn_valid, torch.zeros(1, total - T, dtype=torch.bool, device=dev)], 1)
    t_iota = torch.arange(total, device=dev)
    kk = torch.arange(k, device=dev)
    n_em, last, prev, prev2, npass = 1, next_tok, -1, -1, 0
    while n_em < max_new_tokens and not done:
        b3 = S + n_em - 4
        prev3 = int(hist[b3]) if b3 >= 0 else -1
        drf = _ngram_draft(hist, S + n_em, prev3, prev2, prev, last, k)
        d = np.concatenate([[last], drf])
        pos0 = n_pos0 + n_em - 1
        wslot = T + n_em - 1
        if (drf >= 0).any():
            e = embed(params, torch.as_tensor(np.clip(d, 0, None), device=dev))[None]
            e = e.to(embeds.dtype)
            if fused:
                lg, cache = _verify_forward_fused(params, cfg, e, pos0, cache, wslot, valid)
            else:
                row_extra = (t_iota[None, :] >= wslot) & (t_iota[None, :] <= wslot + kk[:, None])
                m = valid[:, None, :] | row_extra[None]
                lg, cache = decode_forward(params, cfg, e, (pos0 + kk)[None], cache, wslot, m)
            a = lg[0].argmax(-1).tolist()
        else:
            e1 = embed(params, torch.as_tensor([max(last, 0)], device=dev))[None]
            e1 = e1.to(embeds.dtype)
            pos = torch.full((1, 1), pos0, device=dev)
            if fused:
                lg, cache = _decode_forward_fused(params, cfg, e1, pos, cache, wslot, valid)
            else:
                m1 = (valid | (t_iota == wslot)[None])[:, None, :]
                lg, cache = decode_forward(params, cfg, e1, pos, cache, wslot, m1)
            a = [int(lg[0].argmax(-1)[0])] + [-2] * (k - 1)
        acc = 1
        while acc < k and d[acc] == a[acc - 1]:
            acc += 1
        stop_pos = next((j for j in range(acc) if a[j] == stop), k)
        acc = min(acc, stop_pos + 1, max_new_tokens - n_em)
        out[n_em: n_em + acc] = a[:acc]
        hist[S + n_em: S + n_em + acc] = a[:acc]
        valid[:, wslot: wslot + acc] = True
        new_last = a[acc - 1]
        new_prev = a[acc - 2] if acc >= 2 else last
        new_prev2 = a[acc - 3] if acc >= 3 else (last if acc == 2 else prev)
        done = stop_pos < acc
        last, prev, prev2 = new_last, new_prev, new_prev2
        n_em += acc
        npass += 1
    if stats is not None:
        stats.update(tokens=n_em, passes=npass)
    return torch.as_tensor(out, device=dev)[None]


def _verify_forward_grouped(params: Params, cfg: Phi3Config, e: torch.Tensor,
                            pos0: torch.Tensor, cache: KVCache, wslot: torch.Tensor,
                            valid: torch.Tensor, use_fused: bool):
    """Grouped verify pass: ``e [B, g, D]`` = B episodes x g draft rows.

    ``use_fused``: the ``B*g`` rows share one weight stream per layer
    (``decode_layer_ring(group_size=g)``, each episode's cache row streamed
    once, per-row ``pos``) over the flat cache; otherwise ``decode_forward``'s
    layers.  Either way each episode's k/v are scattered at its own slots
    ``wslot[b]..wslot[b]+g-1``.  Returns logits ``[B, g, V]``."""
    B, g, D = e.shape
    dev = e.device
    gg = torch.arange(g, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    slots = wslot[:, None] + gg[None, :]                  # [B, g]
    if use_fused:
        cos, sin = _rope_table(cfg, (pos0[:, None] + gg[None]).reshape(-1))
        x = e.reshape(B * g, 1, D)
        mask_rows = valid.repeat_interleave(g, dim=0)     # [B*g, Tmax]
        posr = wslot.repeat_interleave(g).tolist()
        for li in range(cfg.num_layers):
            p = params["layers"][li]
            x, k_new, v_new = decode_layer_ring(
                x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
                p["gate_up"]["q4"], p["down"]["q4"], cache.k, cache.v, li, posr,
                mask_rows, cos, sin, eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim,
                group_size=g,
            )
            cache.k[li, bidx, slots] = k_new.view(B, g, D).to(cache.k.dtype)
            cache.v[li, bidx, slots] = v_new.view(B, g, D).to(cache.v.dtype)
        x = rms_norm(params["final_ln"], x.reshape(B, g, D), cfg.rms_eps)
        return _lm_head(params, x), cache
    t_iota = torch.arange(valid.shape[1], device=dev)
    row_extra = ((t_iota[None, None] >= wslot[:, None, None])
                 & (t_iota[None, None] <= wslot[:, None, None] + gg[None, :, None]))
    m = valid[:, None, :] | row_extra
    pos = pos0[:, None] + gg[None, :]
    x = e
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        q, k, v = _qkv(p, cfg, x, pos)
        cache.k[li][bidx, slots] = k.to(cache.k.dtype)
        cache.v[li][bidx, slots] = v.to(cache.v.dtype)
        x = _attn_mlp(p, cfg, x, q, cache.k[li], cache.v[li], m)
    x = rms_norm(params["final_ln"], x, cfg.rms_eps)
    return _lm_head(params, x), cache


def greedy_decode_spec_batched(params: Params, cfg: Phi3Config, embeds: torch.Tensor,
                               attn_valid: torch.Tensor, max_new_tokens: int,
                               stop_token: Optional[int] = None,
                               lookup_ids: Optional[torch.Tensor] = None,
                               draft_len: Optional[int] = None,
                               stats: Optional[dict] = None) -> torch.Tensor:
    """Batched speculative greedy decode: B >= 2 episodes each verify ``g``
    draft tokens per pass (``B*g <= 8`` ring rows), so one weight stream
    verifies up to ``g`` tokens for every episode.  Row-wise greedy-exact:
    each row's ids equal :func:`greedy_decode`'s; rows accept independently
    and finished rows coast.  ``lookup_ids [B, S]`` (-1 never matches) seed
    the drafts.  ``stats`` (if given) receives ``tokens`` (per row) and
    ``passes``."""
    B, T, D = embeds.shape
    if B < 2:
        raise ValueError("use greedy_decode_spec at B == 1")
    g = int(draft_len or min(MAX_ROWS // B, flags.SPEC_DRAFT_LEN))
    g = max(2, min(g, max_new_tokens, MAX_ROWS // B))
    fused = _fused_decode_eligible(params, cfg, B * g) and _ring_eligible(params, cfg)
    total = T + max_new_tokens + g
    if fused:
        total = -(-total // ROWS) * ROWS
    first, cache = _prefill(params, cfg, embeds, attn_valid, total)
    if fused:
        cache = _flat(cache, cfg)
    stop = cfg.end_token_id if stop_token is None else stop_token
    dev = embeds.device
    first = first.cpu().numpy().astype(np.int64)

    S = 0 if lookup_ids is None else int(lookup_ids.shape[-1])
    hist = np.full((B, S + max_new_tokens + g + 2), -1, np.int64)
    if lookup_ids is not None:
        hist[:, :S] = lookup_ids.reshape(B, S).to("cpu", torch.int64).numpy()
    hist[:, S] = first
    n_pos0 = attn_valid.sum(1).cpu().numpy().astype(np.int64)
    out = np.full((B, max_new_tokens), cfg.pad_token_id, np.int64)
    out[:, 0] = first
    done = first == stop
    valid = torch.cat([attn_valid, torch.zeros(B, total - T, dtype=torch.bool, device=dev)], 1)
    rows, gg = np.arange(B), np.arange(g)
    n_em = np.ones(B, np.int64)
    last, prev, prev2 = first.copy(), np.full(B, -1, np.int64), np.full(B, -1, np.int64)
    npass = 0
    while bool(np.any(~done & (n_em < max_new_tokens))):
        b3 = S + n_em - 4
        prev3 = np.where(b3 >= 0, hist[rows, np.maximum(b3, 0)], -1)
        drf = np.stack([_ngram_draft(hist[b], int(S + n_em[b]), int(prev3[b]), int(prev2[b]),
                                     int(prev[b]), int(last[b]), g) for b in range(B)])
        d = np.concatenate([last[:, None], drf], axis=1)             # [B, g]
        e = embed(params, torch.as_tensor(np.clip(d, 0, None), device=dev)).to(embeds.dtype)
        wslot = T + n_em - 1
        lg, cache = _verify_forward_grouped(
            params, cfg, e, torch.as_tensor(n_pos0 + n_em - 1, device=dev), cache,
            torch.as_tensor(wslot, device=dev), valid, fused)
        a = lg.argmax(-1).cpu().numpy().astype(np.int64)            # [B, g]
        match = (d[:, 1:] == a[:, :-1]).astype(np.int64)
        acc = 1 + np.cumprod(match, axis=1).sum(axis=1)
        stop_pos = np.where((a == stop) & (gg[None] < acc[:, None]), gg[None], g).min(axis=1)
        acc = np.minimum(np.minimum(acc, stop_pos + 1), max_new_tokens - n_em)
        acc = np.where(done, 0, acc)
        for b in range(B):
            n, w, c = int(n_em[b]), int(wslot[b]), int(acc[b])
            out[b, n: n + c] = a[b, :c]
            hist[b, S + n: S + n + c] = a[b, :c]
            valid[b, w: w + c] = True

        def a_at(off):
            return a[rows, np.clip(acc - off, 0, g - 1)]

        new_last = np.where(acc > 0, a_at(1), last)
        new_prev = np.where(acc >= 2, a_at(2), np.where(acc == 1, last, prev))
        new_prev2 = np.where(acc >= 3, a_at(3),
                             np.where(acc == 2, last, np.where(acc == 1, prev, prev2)))
        done = done | (stop_pos < acc)
        last, prev, prev2 = new_last, new_prev, new_prev2
        n_em = n_em + acc
        npass += 1
    if stats is not None:
        stats.update(tokens=n_em.tolist(), passes=npass)
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

