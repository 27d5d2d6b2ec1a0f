"""Transformer blocks over parameter dicts (``nn.TransformerEncoder`` math).

Port of ``ops/transformer.py``: ``layer_norm``, ``mha``, ``encoder_stack``
and ``mlp2`` with the same parameter layout (``{"w": [in, out], "b"}``).
Every product is accumulated in float32, as the reference requests with
``preferred_element_type``; bf16 activations take bf16-rounded weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
NEG = torch.finfo(torch.float32).min


def weight_like(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 activations use bf16-rounded weights (the reference's rule)."""
    if x.dtype == torch.bfloat16 and w.dtype == torch.float32:
        return w.to(torch.bfloat16)
    return w


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 products and sums (``preferred_element_type
    = float32``): bf16 inputs are exact in float32."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = dot_f32(x, weight_like(x, p["w"]))
    return (y + p["b"]).to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in float32."""
    return F.gelu(x.to(torch.float32)).to(x.dtype)


def mha(
    p: Params, x: torch.Tensor, num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head self-attention, ``nn.MultiheadAttention`` math.

    ``key_padding_mask [..., T]`` and ``attn_mask [..., T, T]`` are True
    where attention is allowed (the reference's convention)."""
    T, D = x.shape[-2], x.shape[-1]
    hd = D // num_heads
    qkv = dense(p["qkv"], x)
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.reshape(*t.shape[:-1], num_heads, hd)

    q, k, v = heads(q), heads(k), heads(v)
    logits = torch.einsum("...qhd,...khd->...hqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if key_padding_mask is not None:
        logits = logits.masked_fill(~key_padding_mask[..., None, None, :], NEG)
    if attn_mask is not None:
        logits = logits.masked_fill(~attn_mask[..., None, :, :], NEG)
    attn = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", attn.to(torch.float32),
                       v.to(torch.float32))
    out = out.reshape(*out.shape[:-2], D).to(x.dtype)
    return dense(p["out"], out)


def encoder_layer(p: Params, x: torch.Tensor, num_heads: int,
                  key_padding_mask=None, attn_mask=None, ln_eps: float = 1e-5) -> torch.Tensor:
    """Post-norm ``nn.TransformerEncoderLayer`` with exact GELU; ``ln_eps``
    is 1e-12 in BERT layers."""
    a = mha(p["attn"], x, num_heads, key_padding_mask, attn_mask)
    x = layer_norm(p["ln1"], x + a, eps=ln_eps)
    h = dense(p["ff2"], gelu(dense(p["ff1"], x)))
    return layer_norm(p["ln2"], x + h, eps=ln_eps)


def encoder_stack(p: Params, x: torch.Tensor, num_heads: int,
                  key_padding_mask=None, attn_mask=None) -> torch.Tensor:
    """N post-norm layers + final LayerNorm (eps 1e-12)."""
    for lp in p["layers"]:
        x = encoder_layer(lp, x, num_heads, key_padding_mask, attn_mask)
    return layer_norm(p["final_ln"], x, eps=1e-12)


def mlp2(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``Linear -> LayerNorm -> GELU -> Linear``."""
    h = dense(p["fc1"], x)
    h = layer_norm(p["ln"], h)
    return dense(p["fc2"], gelu(h))


def init_dense(gen: torch.Generator, d_in: int, d_out: int, device,
               std: Optional[float] = None) -> Params:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(d_in, d_out, generator=gen, device=device) * std
    return {"w": w, "b": torch.zeros(d_out, device=device)}


def init_ln(d: int, device) -> Params:
    return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}


def init_encoder_layer(gen, d: int, d_ff: int, device) -> Params:
    return {
        "attn": {"qkv": init_dense(gen, d, 3 * d, device), "out": init_dense(gen, d, d, device)},
        "ln1": init_ln(d, device),
        "ff1": init_dense(gen, d, d_ff, device),
        "ff2": init_dense(gen, d_ff, d, device),
        "ln2": init_ln(d, device),
    }


def init_encoder_stack(gen, d: int, d_ff: int, n_layers: int, device) -> Params:
    return {
        "layers": [init_encoder_layer(gen, d, d_ff, device) for _ in range(n_layers)],
        "final_ln": init_ln(d, device),
    }


def init_mlp2(gen, d_in: int, d_hidden: int, d_out: int, device) -> Params:
    return {
        "fc1": init_dense(gen, d_in, d_hidden, device),
        "ln": init_ln(d_hidden, device),
        "fc2": init_dense(gen, d_hidden, d_out, device),
    }
