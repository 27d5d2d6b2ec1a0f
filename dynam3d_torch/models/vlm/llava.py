"""LLaVA-Phi-3-mini: vision tower + projector + prompt splice + generation
and the teacher-forced loss; port of ``models/vlm/llava.py``
(``image_features``, ``splice_embeds``, ``teacher_forced_loss``,
``generate``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from dynam3d_torch import flags
from dynam3d_torch.config import CLIPConfig, LLaVAConfig
from dynam3d_torch.device import resolve_device
from dynam3d_torch.models.encoders import clip as clip_mod
from dynam3d_torch.models.vlm import phi3
from dynam3d_torch.ops.transformer import dot_f32, gelu, init_dense, weight_like

Params = Dict[str, Any]


def image_features(params: Params, llava_cfg: LLaVAConfig, clip_cfg: CLIPConfig,
                   pixels: torch.Tensor) -> torch.Tensor:
    """CLIP tower hidden states at ``vision_feature_layer`` (CLS dropped)
    through the 2-layer GELU projector."""
    hidden = clip_mod.encode_image(params["clip"], clip_cfg, pixels,
                                   hidden_layer=llava_cfg.vision_feature_layer)
    patches = hidden[:, 1:, :]
    p = params["projector"]
    h = dot_f32(patches, weight_like(patches, p["fc1"]["w"])) + p["fc1"]["b"]
    h = gelu(h.to(patches.dtype))
    h = dot_f32(h, weight_like(h, p["fc2"]["w"])) + p["fc2"]["b"]
    return h.to(patches.dtype)


def splice_embeds(params: Params, cfg: LLaVAConfig, input_ids: torch.Tensor,
                  mm_tokens: torch.Tensor, splice_start: int = 2) -> torch.Tensor:
    """Token embeddings with ``mm_tokens [B, N, D]`` written over the
    ``<image>`` span starting at ``splice_start``."""
    emb = phi3.embed(params["phi3"], input_ids).to(mm_tokens.dtype)
    emb[:, splice_start: splice_start + mm_tokens.shape[1]] = mm_tokens
    return emb


class TrainOutput(NamedTuple):
    loss: torch.Tensor
    logits_at_labels: torch.Tensor  # [B, Tg, V] logits aligned to the label tokens


def teacher_forced_loss(params: Params, cfg: LLaVAConfig, embeds: torch.Tensor,
                        attn_valid: torch.Tensor, label_ids: torch.Tensor,
                        label_mask: torch.Tensor, prompt_len: torch.Tensor,
                        turn_token_weight: torch.Tensor) -> TrainOutput:
    """CE over the label span plus a CE on label token 1 (the turn
    direction) weighted by ``turn_token_weight [B]``.  ``embeds [B, T, D]``
    hold prompt and labels; the logits at positions ``prompt_len - 1 + j``
    (clipped to the sequence) predict ``label_ids[:, j]``, and only those
    rows reach the lm_head (the same values and gradients as gathering full
    logits, without the ``[B, T, V]`` float32 tensor)."""
    B, T, _ = embeds.shape
    positions = torch.clamp(torch.cumsum(attn_valid.to(torch.int64), dim=1) - 1, min=0)
    mask = phi3.prefill_mask(attn_valid, T)
    Tg = label_ids.shape[1]
    idx = (prompt_len[:, None] - 1) + torch.arange(Tg, device=embeds.device)[None, :]
    idx = torch.clamp(idx, 0, T - 1)
    sel = phi3.forward_train(params["phi3"], cfg.phi3, embeds, positions, mask, lm_rows=idx)
    logp = torch.log_softmax(sel, dim=-1)
    nll = -torch.gather(logp, -1, label_ids[..., None].to(torch.int64))[..., 0]
    lm = label_mask.to(nll.dtype)
    per_row = (nll * lm).sum(dim=1) / torch.clamp(lm.sum(dim=1), min=1)
    turn_nll = nll[:, 1] * turn_token_weight
    return TrainOutput(torch.mean(per_row + turn_nll), sel)


def generate(params: Params, cfg: LLaVAConfig, embeds: torch.Tensor,
             attn_valid: torch.Tensor, max_new_tokens: Optional[int] = None,
             lookup_ids: Optional[torch.Tensor] = None,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy generation.  With ``DYNAM3D_SPEC_DECODE`` (on by default):
    speculative at B=1, grouped speculation at B=2..4 (B episodes x 8//B
    drafts share one weight stream per verify pass); plain greedy
    otherwise.  Speculation is greedy-exact, so every route gives the same
    ids."""
    n = max_new_tokens or cfg.max_new_tokens
    B = embeds.shape[0]
    if flags.spec_decode() and B == 1:
        return phi3.greedy_decode_spec(params["phi3"], cfg.phi3, embeds, attn_valid, n,
                                       lookup_ids=lookup_ids, stats=stats)
    if flags.spec_decode() and 2 <= B <= 4 and n >= 2:
        return phi3.greedy_decode_spec_batched(params["phi3"], cfg.phi3, embeds, attn_valid,
                                               n, lookup_ids=lookup_ids, stats=stats)
    return phi3.greedy_decode(params["phi3"], cfg.phi3, embeds, attn_valid, n)


def init_llava_params(gen: torch.Generator, cfg: LLaVAConfig, clip_cfg: CLIPConfig,
                      dtype=torch.bfloat16, device=None) -> Params:
    """Random CLIP tower, projector and Phi-3 parameters on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    return {
        "clip": clip_mod.init_clip_params(gen, clip_cfg, device),
        "projector": {
            "fc1": init_dense(gen, clip_cfg.vision_width, cfg.projector_hidden, device),
            "fc2": init_dense(gen, cfg.projector_hidden, cfg.phi3.hidden_size, device),
        },
        "phi3": phi3.init_phi3_params(gen, cfg.phi3, dtype=dtype, device=device),
    }
