"""CLIP ViT-L/14@336px, vision and text towers; port of
``models/encoders/clip.py`` (``preprocess_rgb``, ``encode_image`` with
``hidden_layer``, ``encode_text``, ``encode_all_text``).

The tower returns the projected CLS feature and ALL projected patch tokens
(the reference's modified forward), or the raw hidden states after
``n_blocks + hidden_layer + 1`` blocks when ``hidden_layer`` is given (the
LLaVA tower's ``vision_feature_layer=-2``).  The text tower is causal and
reads the feature at each row's EOT (the argmax id).  Products accumulate in
f32; activations keep the input's dtype between ops (the pixels', or the
token embedding's), as in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from dynam3d_torch.config import CLIPConfig
from dynam3d_torch.ops.transformer import (
    dot_f32, init_dense, init_ln, layer_norm, weight_like,
)

Params = Dict[str, Any]
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attn(p: Params, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    D = x.shape[-1]
    hd = D // heads
    qkv = (dot_f32(x, weight_like(x, p["qkv"]["w"])) + p["qkv"]["b"]).to(x.dtype)
    q, k, v = (t.reshape(*t.shape[:-1], heads, hd) for t in qkv.split(D, dim=-1))
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    a = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("...hqk,...khd->...qhd", a.float(), v.float())
    o = o.reshape(*o.shape[:-2], D).to(x.dtype)
    return (dot_f32(o, weight_like(x, p["out"]["w"])) + p["out"]["b"]).to(x.dtype)


def _block(p: Params, x: torch.Tensor, heads: int,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm residual attention block with QuickGELU; ``mask`` is added
    to the attention logits."""
    x = x + _attn(p["attn"], layer_norm(p["ln1"], x), heads, mask)
    h = layer_norm(p["ln2"], x)
    h = dot_f32(h, weight_like(h, p["fc1"]["w"])) + p["fc1"]["b"]
    h = _quick_gelu(h.to(x.dtype))
    h = dot_f32(h, weight_like(h, p["fc2"]["w"])) + p["fc2"]["b"]
    return x + h.to(x.dtype)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def resize_weights(n_in: int, n_out: int, device, kernel=_keys_cubic) -> torch.Tensor:
    """``[n_in, n_out]`` weights of ``jax.image.resize`` with ``kernel``
    (Keys a=-0.5 for ``method="cubic"``), the kernel widened by the
    downscale factor (antialias)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = kernel(x / kernel_scale)
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def preprocess_rgb(rgb: torch.Tensor, size: int = 336) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> CLIP-normalized float ``[B, size, size, 3]``."""
    x = rgb.to(torch.float32) / 255.0
    if rgb.shape[1] != size or rgb.shape[2] != size:
        wh = resize_weights(rgb.shape[1], size, rgb.device)
        ww = resize_weights(rgb.shape[2], size, rgb.device)
        x = torch.einsum("bhwc,hy,wx->byxc", x, wh, ww)
    mean = torch.tensor(CLIP_MEAN, device=rgb.device)
    std = torch.tensor(CLIP_STD, device=rgb.device)
    return (x - mean) / std


def encode_image(params: Params, cfg: CLIPConfig, pixels: torch.Tensor,
                 hidden_layer: Optional[int] = None):
    """Vision tower over normalized ``pixels [B, H, W, 3]``.

    Returns ``(cls [B, E], patches [B, G*G, E])`` or, with ``hidden_layer``,
    the hidden states ``[B, 1 + G*G, width]`` after that many blocks."""
    v = params["visual"]
    B = pixels.shape[0]
    g, ps = cfg.grid, cfg.patch_size
    x = pixels.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, ps * ps * 3)
    x = dot_f32(x, weight_like(x, v["conv1_w"])).to(pixels.dtype)
    cls = v["class_embedding"].expand(B, 1, cfg.vision_width).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + v["positional_embedding"].to(x.dtype)
    x = layer_norm(v["ln_pre"], x)
    blocks = v["transformer"]["blocks"]
    stop = len(blocks) if hidden_layer is None else len(blocks) + hidden_layer + 1
    for bp in blocks[:stop]:
        x = _block(bp, x, cfg.vision_heads)
    if hidden_layer is not None:
        return x
    patches = layer_norm(v["ln_post"], x[:, 1:, :])
    cls_out = layer_norm(v["ln_post"], x[:, 0, :])
    proj = weight_like(x, v["proj"])
    return dot_f32(cls_out, proj).to(x.dtype), dot_f32(patches, proj).to(x.dtype)


def _text_hidden(params: Params, cfg: CLIPConfig, tokens: torch.Tensor) -> torch.Tensor:
    t = params["text"]
    x = t["token_embedding"][tokens.to(torch.int64)] + t["positional_embedding"]
    T = cfg.text_context
    causal = torch.where(torch.ones(T, T, dtype=torch.bool, device=x.device).tril(),
                         0.0, torch.finfo(torch.float32).min)
    for bp in t["transformer"]["blocks"]:
        x = _block(bp, x, cfg.text_heads, causal)
    return layer_norm(t["ln_final"], x)


def encode_text(params: Params, cfg: CLIPConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Projected feature ``[B, embed_dim]`` (float32) at each row's EOT,
    the argmax token id."""
    x = _text_hidden(params, cfg, tokens)
    eot = torch.argmax(tokens, dim=-1)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return dot_f32(feats, params["text"]["projection"])


def encode_all_text(params: Params, cfg: CLIPConfig,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected features of every token ``[B, T, embed_dim]``, zero after
    the EOT, and the EOT feature ``[B, embed_dim]`` (float32)."""
    x = dot_f32(_text_hidden(params, cfg, tokens), params["text"]["projection"])
    eot = torch.argmax(tokens, dim=-1)
    sep = x[torch.arange(x.shape[0], device=x.device), eot]
    keep = torch.arange(cfg.text_context, device=x.device)[None, :] <= eot[:, None]
    return x * keep[..., None], sep


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig, device) -> Params:
    """Random parameters of both towers.  The text tower draws from a
    generator of its own (seeded one past ``gen``'s seed), so the vision
    tower and whatever ``gen`` draws next are the same with or without it."""
    vw, tw = cfg.vision_width, cfg.text_width
    scale = vw ** -0.5

    def block(g, d):
        return {
            "attn": {"qkv": init_dense(g, d, 3 * d, device),
                     "out": init_dense(g, d, d, device)},
            "ln1": init_ln(d, device),
            "ln2": init_ln(d, device),
            "fc1": init_dense(g, d, 4 * d, device),
            "fc2": init_dense(g, 4 * d, d, device),
        }

    def randn(*shape, g=gen):
        return torch.randn(*shape, generator=g, device=device)

    visual = {
        "conv1_w": randn(cfg.patch_size ** 2 * 3, vw) * scale,
        "class_embedding": scale * randn(vw),
        "positional_embedding": scale * randn(cfg.grid ** 2 + 1, vw),
        "ln_pre": init_ln(vw, device),
        "transformer": {"blocks": [block(gen, vw) for _ in range(cfg.vision_layers)]},
        "ln_post": init_ln(vw, device),
        "proj": scale * randn(vw, cfg.embed_dim),
    }
    tg = torch.Generator(device=gen.device).manual_seed(gen.initial_seed() + 1)
    text = {
        "token_embedding": 0.02 * randn(cfg.vocab_size, tw, g=tg),
        "positional_embedding": 0.01 * randn(cfg.text_context, tw, g=tg),
        "transformer": {"blocks": [block(tg, tw) for _ in range(cfg.text_layers)]},
        "ln_final": init_ln(tw, device),
        "projection": tw ** -0.5 * randn(tw, cfg.embed_dim, g=tg),
    }
    return {"visual": visual, "text": text}
