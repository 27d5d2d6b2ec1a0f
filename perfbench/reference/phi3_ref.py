"""Plain float32 Phi-3-mini over a prompt and the tokens served after it.

The served configuration stores each projection twice, both derived from
the bf16 weights: int8 with one scale per column (``max|w| / 127``) for the
prompt, whose activations are also quantized to int8 per token (W8A8), and
int4 with one scale per 1024-row group and column (``max|w| / 7``, round
half to even, clipped to [-7, 7]) for every product of at most 16 rows: the
decode passes and the head at the prompt's last token.  This module works
both out again from the bf16 weights and computes everything else in
float32 with TF32 off: RMSNorm, rotary embedding over the whole head,
softmax attention, SwiGLU.

:func:`served_logits` runs a list of requests layer by layer, so each
layer's weights are dequantized once for all of them.  A request is the
prompt's embeddings (valid positions only, in order) and its served ids;
the result is the logits that predict each served token: the prompt's last
position, then each served token but the last.  ``bits`` sets the
precisions, so the same code gives the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import torch

GROUP = 1024


class Bits(NamedTuple):
    prompt_w: int = 8      # per-column weights of the prompt's products
    prompt_a: int = 8      # per-token activations of the prompt's products
    decode_w: int = 4      # per-group weights of the decode products and head


SERVED = Bits()
CONTROL = Bits(prompt_w=4, prompt_a=4, decode_w=3)


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def dequant_cols(w: torch.Tensor, bits: int) -> torch.Tensor:
    wf = w.to(torch.float32)
    s = torch.clamp(wf.abs().amax(dim=0, keepdim=True) / _qmax(bits), min=1e-8)
    return torch.clamp(torch.round(wf / s), -_qmax(bits), _qmax(bits)) * s


def dequant_groups(w: torch.Tensor, bits: int, group: int = GROUP) -> torch.Tensor:
    d, n = w.shape
    dp = -(-d // group) * group
    wf = torch.zeros((dp, n), dtype=torch.float32, device=w.device)
    wf[:d] = w.to(torch.float32)
    g = wf.view(dp // group, group, n)
    s = torch.clamp(g.abs().amax(dim=1, keepdim=True) / _qmax(bits), min=1e-8)
    q = torch.clamp(torch.round(g / s), -_qmax(bits), _qmax(bits))
    return (q * s).view(dp, n)[:d]


def quant_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / _qmax(bits), min=1e-8)
    return torch.clamp(torch.round(x / s), -_qmax(bits), _qmax(bits)) * s


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.to(torch.float32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [T, H, hd]``: rotate-half pairs (i, i + hd/2) over the full head."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Request(NamedTuple):
    embeds: torch.Tensor   # [n, D] f32, the prompt's valid positions
    served: torch.Tensor   # [S] int64, S >= 1


def _layer_weights(lp: Dict, bits: Bits) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: {"p": dequant_cols(lp[name], bits.prompt_w),
                   "d": dequant_groups(lp[name], bits.decode_w)}
            for name in ("qkv", "o", "gate_up", "down")}


def _prompt_mm(x: torch.Tensor, w: torch.Tensor, bits: Bits) -> torch.Tensor:
    return quant_rows(x, bits.prompt_a) @ w


def served_logits(params: Dict, cfg, requests: Sequence[Request],
                  bits: Bits = SERVED) -> List[torch.Tensor]:
    """``[S, V]`` float32 logits per request (see the module docstring).
    ``params``: the bf16 Phi-3 tree (``embed_tokens``, ``layers``,
    ``final_ln``, ``lm_head``); ``cfg``: its sizes."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    emb = params["embed_tokens"]
    xs_p = [r.embeds.to(torch.float32) for r in requests]
    xs_d = [emb[r.served[:-1]].to(torch.float32) for r in requests]
    for lp in params["layers"]:
        w = _layer_weights(lp, bits)
        for i, r in enumerate(requests):
            n, S1 = xs_p[i].shape[0], xs_d[i].shape[0]
            pos_p = torch.arange(n, device=emb.device)
            pos_d = torch.arange(n, n + S1, device=emb.device)
            hp = rms_norm(lp["input_ln"], xs_p[i], cfg.rms_eps)
            hd_ = rms_norm(lp["input_ln"], xs_d[i], cfg.rms_eps)
            qkv_p = _prompt_mm(hp, w["qkv"]["p"], bits)
            qkv_d = hd_ @ w["qkv"]["d"]
            qkv = torch.cat([qkv_p, qkv_d], 0)
            q_sz, kv_sz = H * hd, Hkv * hd
            T = n + S1
            pos = torch.cat([pos_p, pos_d])
            q = rope(qkv[:, :q_sz].view(T, H, hd), pos, cfg.rope_theta)
            k = rope(qkv[:, q_sz: q_sz + kv_sz].view(T, Hkv, hd), pos, cfg.rope_theta)
            v = qkv[:, q_sz + kv_sz:].view(T, Hkv, hd)
            if group > 1:
                k = k.repeat_interleave(group, dim=1)
                v = v.repeat_interleave(group, dim=1)
            att = torch.einsum("qhd,khd->hqk", q, k) * scale
            causal = torch.ones(T, T, dtype=torch.bool, device=att.device).tril()
            att = att.masked_fill(~causal, float("-inf")).softmax(-1)
            o = torch.einsum("hqk,khd->qhd", att, v).reshape(T, H * hd)
            xp = xs_p[i] + _prompt_mm(o[:n], w["o"]["p"], bits)
            xd = xs_d[i] + o[n:] @ w["o"]["d"]
            gu_p = _prompt_mm(rms_norm(lp["post_ln"], xp, cfg.rms_eps), w["gate_up"]["p"], bits)
            gu_d = rms_norm(lp["post_ln"], xd, cfg.rms_eps) @ w["gate_up"]["d"]
            g_p, u_p = gu_p.chunk(2, dim=-1)
            g_d, u_d = gu_d.chunk(2, dim=-1)
            xs_p[i] = xp + _prompt_mm(torch.nn.functional.silu(g_p) * u_p, w["down"]["p"], bits)
            xs_d[i] = xd + (torch.nn.functional.silu(g_d) * u_d) @ w["down"]["d"]
        del w
    head = dequant_groups(params["lm_head"], bits.decode_w)
    out = []
    for i in range(len(requests)):
        x = torch.cat([xs_p[i][-1:], xs_d[i]], 0)
        out.append(rms_norm(params["final_ln"], x, cfg.rms_eps) @ head)
    return out


def gaps(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """How far each id's logit lies below its row's best (>= 0)."""
    return logits.max(dim=-1).values - logits.gather(-1, ids[:, None])[:, 0]
