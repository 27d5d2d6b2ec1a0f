"""Dynam3D VLN policy: RGB-D -> layered 3D tokens -> LLaVA action ids.

Port of ``models/policy.py``: ``init_policy_params``, ``perceive``,
``generate_action_ids`` (with ``prev_gen`` draft priming), the
teacher-forced ``train_loss``, ``full_step``, ``batched_init_state`` and
``pop_state``.

Sequence layout: ``[BOS <|user|> \\n][576*V patch tokens][<=I_ENV instance]
[<=Z_ENV zone][\\nInstruction: ...][History ...][<|end|>...]``; instance and
zone slots beyond the live count are masked out and RoPE positions come from
the validity cumsum, so the masked slots are positionally invisible.

Segmentation runs the provider the config names, as the reference does:
the learned YOLOv8-seg (FastSAM) provider by default, on every view, or the
geometric ``depth_plane`` provider.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.geom.projection import habitat_to_world, patch_3d_info
from dynam3d_torch.models.encoders import clip as clip_mod
from dynam3d_torch.models.encoders import yolov8_seg
from dynam3d_torch.models.encoders.depth_resnet import preprocess_depth
from dynam3d_torch.models.memory3d import (
    FieldState, delete_from_frustum, environment_features, init_field_params,
    init_state, update_views,
)
from dynam3d_torch.models.memory3d.state import stack_states, unstack_state
from dynam3d_torch.models.segmenter import depth_plane_segments
from dynam3d_torch.models.vlm import llava as llava_mod
from dynam3d_torch.ops.segment import first_free_slots
from dynam3d_torch.ops.transformer import init_mlp2, mlp2

Params = Dict[str, Any]

I_ENV = 64
Z_ENV = 64


def _first_k_true_idx(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = first_free_slots(~mask, k)
    return idx, torch.arange(k, device=mask.device) < mask.sum()


def nearest_resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2 INTER_NEAREST-compatible resize over the trailing two dims (the
    source index is computed in float32, as the reference does)."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    ri = torch.floor(torch.arange(out_h, dtype=torch.float32, device=x.device)
                     * torch.tensor(in_h / out_h, dtype=torch.float32)).long()
    ci = torch.floor(torch.arange(out_w, dtype=torch.float32, device=x.device)
                     * torch.tensor(in_w / out_w, dtype=torch.float32)).long()
    return x[..., ri, :][..., ci]


class PerceiveOut(NamedTuple):
    state: FieldState
    mm_tokens: torch.Tensor    # [B, N_mm, D_llm]
    mm_valid: torch.Tensor     # [B, N_mm] bool
    n_inst: torch.Tensor       # [B]
    n_zone: torch.Tensor       # [B]


def _generator(gen: Union[int, torch.Generator], device: torch.device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, parameters on {device}")
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def init_policy_params(gen: Union[int, torch.Generator], cfg: Dynam3DConfig,
                       llm_dtype=torch.bfloat16, device: DeviceLike = None) -> Params:
    """Random parameters of every module on the serving path, made on
    ``device`` (the card unless ``device="cpu"``) from a ``torch.Generator``
    or an integer seed."""
    device = resolve_device(device)
    g = _generator(gen, device)
    d, dl = cfg.fields.fts_dim, cfg.llava.phi3.hidden_size
    params = {
        "fields": init_field_params(g, cfg.fields, device),
        "clip": clip_mod.init_clip_params(g, cfg.clip, device),
        "llava": llava_mod.init_llava_params(g, cfg.llava, cfg.clip, dtype=llm_dtype,
                                             device=device),
        "patch_pos_emb": init_mlp2(g, 6, dl, dl, device),
        "inst_pos_emb": init_mlp2(g, 3, d, d, device),
        "zone_pos_emb": init_mlp2(g, 3, d, d, device),
        "inst_proj": init_mlp2(g, 2 * d, dl, dl, device),
        "zone_proj": init_mlp2(g, 2 * d, dl, dl, device),
    }
    if cfg.segmenter.provider == "yolov8":
        seg = cfg.segmenter
        params["yolo"] = yolov8_seg.init_yolov8_params(
            g, width=seg.width_mult, depth_n=seg.depth_layers(), num_protos=seg.num_protos,
            device=device)
    return params


def perceive(params: Params, cfg: Dynam3DConfig, state: FieldState,
             rgb: torch.Tensor, depth_raw: torch.Tensor, position_hab: torch.Tensor,
             heading: torch.Tensor, delete_old: bool = True) -> PerceiveOut:
    """Encoders -> frustum forgetting -> memory update -> multimodal tokens.

    ``rgb [B, V, Hc, Wc, 3]`` uint8, ``depth_raw [B, V, Hd, Wd]`` normalized
    depth (f32, or the uint16 wire format dequantized here), habitat
    ``position_hab [B, 3]`` and ``heading [B]``; ``state`` is batched."""
    if depth_raw.dtype == torch.uint16:
        depth_raw = depth_raw.to(torch.float32) * (1.0 / 65535.0)
    f = cfg.fields
    B, V = rgb.shape[0], rgb.shape[1]
    H, W = f.input_height, f.input_width
    HW = H * W

    d24 = nearest_resize_hw(depth_raw, H, W)
    d24 = preprocess_depth(d24.reshape(B * V, H, W)[..., None])[..., 0].reshape(B, V, HW)
    dfull = preprocess_depth(
        depth_raw.reshape(B * V, *depth_raw.shape[2:])[..., None]
    )[..., 0].reshape(B, V, *depth_raw.shape[2:])

    pixels = clip_mod.preprocess_rgb(rgb.reshape(B * V, *rgb.shape[2:]), cfg.clip.image_size)
    if cfg.clip.compute_dtype == "bf16":
        pixels = pixels.to(torch.bfloat16)
    _, grid = clip_mod.encode_image(params["clip"], cfg.clip, pixels)
    grid = grid.reshape(B, V, HW, f.fts_dim)
    # the reference rounds grid features through fp16 before the tables
    grid = grid.to(torch.float16).to(grid.dtype)

    if cfg.segmenter.provider == "yolov8" and "yolo" in params:
        segm = yolov8_seg.segment_views(params["yolo"], cfg.segmenter,
                                        rgb.reshape(B * V, *rgb.shape[2:]), (H, W),
                                        f.max_segments)
    else:
        segm = depth_plane_segments(d24.reshape(B * V, HW), H, W, f.max_segments)
    segm = segm.reshape(B, V, HW)
    pos_world = habitat_to_world(position_hab.to(torch.float32))
    heading = heading.to(torch.float32)
    view_offsets = torch.arange(V, dtype=torch.float32, device=rgb.device) * (-math.pi / 6.0)
    headings_v = heading[:, None] + view_offsets[None, :]

    new_states = []
    for b in range(B):
        st = unstack_state(state, b)
        if delete_old:
            # every view culls with the un-offset heading, as the reference does
            for v in range(V):
                st = delete_from_frustum(st, f, dfull[b, v], pos_world[b], headings_v[b, 0])
        st = update_views(params["fields"], st, f, d24[b], grid[b], segm[b],
                          pos_world[b], headings_v[b])
        new_states.append(st)
    state = stack_states(new_states)

    inst_tok, inst_fill, zone_tok, zone_fill = [], [], [], []
    for b, st in enumerate(new_states):
        env = environment_features(st, pos_world[b], heading[b],
                                   cfg.eval.instance_distance, cfg.eval.zone_distance)
        ii, ifill = _first_k_true_idx(env.inst_mask, I_ENV)
        zi, zfill = _first_k_true_idx(env.zone_mask, Z_ENV)
        inst = torch.cat([env.inst_fts[ii],
                          mlp2(params["inst_pos_emb"], env.inst_rel_pos[ii])], dim=-1)
        zone = torch.cat([env.zone_fts[zi],
                          mlp2(params["zone_pos_emb"], env.zone_rel_pos[zi])], dim=-1)
        inst_tok.append(mlp2(params["inst_proj"], inst))
        zone_tok.append(mlp2(params["zone_proj"], zone))
        inst_fill.append(ifill)
        zone_fill.append(zfill)
    inst_tok, zone_tok = torch.stack(inst_tok), torch.stack(zone_tok)
    inst_fill, zone_fill = torch.stack(inst_fill), torch.stack(zone_fill)

    tower_feats = llava_mod.image_features(params["llava"], cfg.llava, cfg.clip, pixels)
    px, py, pz, pdir, pscale = patch_3d_info(
        d24.reshape(B * V, HW), height=H, width=W,
        hfov_deg=f.input_hfov, vfov_deg=f.input_vfov,
    )
    p3d = torch.stack([px, py, pz, torch.sin(pdir), torch.cos(pdir), pscale], dim=-1)
    patch_tok = (tower_feats + mlp2(params["patch_pos_emb"], p3d)).reshape(B, V * HW, -1)

    llm_dtype = params["llava"]["phi3"]["embed_tokens"].dtype
    mm = torch.cat([patch_tok.to(llm_dtype), inst_tok.to(llm_dtype),
                    zone_tok.to(llm_dtype)], dim=1)
    mm_valid = torch.cat([torch.ones(B, V * HW, dtype=torch.bool, device=rgb.device),
                          inst_fill, zone_fill], dim=1)
    return PerceiveOut(state, mm, mm_valid, inst_fill.sum(1), zone_fill.sum(1))


def _attn_valid(text_valid: torch.Tensor, mm_valid: torch.Tensor,
                splice_start: int) -> torch.Tensor:
    attn_valid = text_valid.clone()
    attn_valid[:, splice_start: splice_start + mm_valid.shape[1]] = mm_valid
    return attn_valid


def generate_action_ids(params: Params, cfg: Dynam3DConfig, input_ids: torch.Tensor,
                        text_valid: torch.Tensor, mm_tokens: torch.Tensor,
                        mm_valid: torch.Tensor, splice_start: int = 2,
                        prev_gen: Optional[torch.Tensor] = None,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Splice + greedy decode.  The draft source of speculative decode is
    the prompt's text ids (the image span and pads never match) followed by
    ``prev_gen``, the previous step's ids with pads masked."""
    p3 = cfg.llava.phi3
    emb = llava_mod.splice_embeds(params["llava"], cfg.llava, input_ids, mm_tokens, splice_start)
    attn_valid = _attn_valid(text_valid, mm_valid, splice_start)
    lookup_ids = torch.where(text_valid & (input_ids != p3.image_token_id), input_ids,
                             torch.full_like(input_ids, -1))
    if prev_gen is not None:
        prev = torch.where(prev_gen == p3.pad_token_id, torch.full_like(prev_gen, -1), prev_gen)
        lookup_ids = torch.cat([lookup_ids, prev.to(lookup_ids.dtype)], dim=1)
    return llava_mod.generate(params["llava"], cfg.llava, emb, attn_valid,
                              lookup_ids=lookup_ids, stats=stats)


def train_loss(params: Params, cfg: Dynam3DConfig, input_ids: torch.Tensor,
               text_valid: torch.Tensor, mm_tokens: torch.Tensor, mm_valid: torch.Tensor,
               label_ids: torch.Tensor, label_mask: torch.Tensor,
               turn_token_weight: torch.Tensor, splice_start: int = 2) -> llava_mod.TrainOutput:
    """Teacher-forced CE on the action span.  The prompt length is the
    physical one (valid text tokens less the labels, which follow the
    prompt): the count of valid attention slots would undercount it by the
    masked instance and zone slots."""
    emb = llava_mod.splice_embeds(params["llava"], cfg.llava, input_ids, mm_tokens, splice_start)
    attn_valid = _attn_valid(text_valid, mm_valid, splice_start)
    prompt_len = text_valid.to(torch.int64).sum(1) - label_mask.to(torch.int64).sum(1)
    return llava_mod.teacher_forced_loss(params["llava"], cfg.llava, emb, attn_valid,
                                         label_ids, label_mask, prompt_len, turn_token_weight)


def full_step(params: Params, cfg: Dynam3DConfig, state: FieldState, rgb, depth_raw,
              position_hab, heading, input_ids, text_valid, splice_start: int = 2,
              prev_gen: Optional[torch.Tensor] = None,
              stats: Optional[dict] = None) -> Tuple[FieldState, torch.Tensor]:
    """Perceive + generate; returns ``(new_state, ids [B, max_new_tokens])``."""
    out = perceive(params, cfg, state, rgb, depth_raw, position_hab, heading)
    if stats is not None:
        stats["mm_finite"] = bool(torch.isfinite(out.mm_tokens.float()).all())
    gen = generate_action_ids(params, cfg, input_ids, text_valid, out.mm_tokens,
                              out.mm_valid, splice_start, prev_gen=prev_gen, stats=stats)
    return out.state, gen


def batched_init_state(cfg: Dynam3DConfig, batch: int, device: DeviceLike = None) -> FieldState:
    one = init_state(cfg.fields, resolve_device(device))
    return FieldState(*(t.unsqueeze(0).repeat(batch, *([1] * t.dim())) for t in one))


def pop_state(state: FieldState, index: int) -> FieldState:
    """Drop one episode from the batch."""
    B = state.patch_pos.shape[0]
    keep = torch.tensor([i for i in range(B) if i != index], dtype=torch.int64,
                        device=state.patch_pos.device)
    return FieldState(*(t[keep] for t in state))
