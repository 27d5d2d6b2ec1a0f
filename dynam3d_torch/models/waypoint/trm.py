"""Frozen waypoint predictor and candidate extraction; port of
``models/waypoint/trm.py``.

12-view depth features -> a 768-d embedding per view -> BERT layers
(LayerNorm eps 1e-12) under a +-1-neighbour circular attention mask -> a
120-angle x 12-distance heatmap rolled by the +5 offset -> softmax ->
wrap-padded NMS (at most 5 peaks) -> candidate (angle, distance) pairs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from dynam3d_torch.config import WaypointConfig
from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.ops.nms import heatmap_nms
from dynam3d_torch.ops.transformer import dense, encoder_layer, init_dense, init_encoder_layer

Params = Dict[str, Any]


def neighbor_attention_mask(num_imgs: int = 12, neighbor: int = 1) -> np.ndarray:
    """Circulant +-``neighbor`` mask, True where attention is allowed."""
    mask = np.zeros((num_imgs, num_imgs), bool)
    t = np.zeros(num_imgs, bool)
    t[: neighbor + 1] = True
    if neighbor != 0:
        t[-neighbor:] = True
    for ri in range(num_imgs):
        mask[ri] = t
        t = np.roll(t, 1)
    return mask


def predict_heatmap(params: Params, cfg: WaypointConfig, depth_feats: torch.Tensor) -> torch.Tensor:
    """Depth features ``[B * 12, F]`` in clockwise view order -> heatmap
    logits ``[B, num_angles, n_classes]`` with the offset roll applied."""
    B12 = depth_feats.shape[0]
    B = B12 // cfg.num_imgs
    x = torch.relu(dense(params["visual_fc_depth"], depth_feats.reshape(B12, -1)))
    x = x.reshape(B, cfg.num_imgs, cfg.hidden_dim)
    mask = torch.from_numpy(neighbor_attention_mask(cfg.num_imgs, cfg.trm_neighbor)).to(x.device)
    for lp in params["bert_layers"]:
        x = encoder_layer(lp, x, cfg.num_attention_heads, attn_mask=mask[None], ln_eps=1e-12)
    logits = dense(params["cls_fc2"], torch.relu(dense(params["cls_fc1"], x)))
    logits = logits.reshape(B, cfg.num_angles, cfg.n_classes)
    off = cfg.heatmap_offset
    return torch.cat([logits[:, off:], logits[:, :off]], dim=1)


class Candidates(NamedTuple):
    """``max_candidates`` slots with a validity mask."""

    angles_ccw: torch.Tensor   # [B, K] counter-clockwise radians
    distances: torch.Tensor    # [B, K] metres
    img_idxes: torch.Tensor    # [B, K] panorama view (counter-clockwise)
    mask: torch.Tensor         # [B, K] bool


def extract_candidates(cfg: WaypointConfig, heatmap_logits: torch.Tensor) -> Candidates:
    """Heatmap logits -> candidates: softmax over the whole map, one wrapped
    angle row on each side, NMS, then ``angle = 2 pi - idx / 120 * 2 pi``,
    ``distance = (bin + 1) * 0.25`` and ``view = 12 - (idx + 5) // 10``
    (mod 12) at the ``max_candidates`` largest peaks (value > 0)."""
    B, K = heatmap_logits.shape[0], cfg.max_candidates
    probs = torch.softmax(heatmap_logits.reshape(B, -1), dim=1)
    probs = probs.reshape(B, cfg.num_angles, cfg.n_classes)
    wrapped = torch.cat([probs[:, -1:], probs, probs[:, :1]], dim=1)
    peaks = heatmap_nms(wrapped, K, cfg.nms_sigma)[:, 1:-1]
    vals, flat_idx = torch.topk(peaks.reshape(B, -1), K, dim=1)
    angle_idx = flat_idx // cfg.n_classes
    dist_idx = flat_idx % cfg.n_classes
    mask = vals > 0
    angles = 2.0 * math.pi - angle_idx.to(torch.float32) / cfg.num_angles * 2.0 * math.pi
    distances = (dist_idx + 1).to(torch.float32) * 0.25
    img = cfg.num_imgs - torch.div(angle_idx + 5, 10, rounding_mode="floor")
    img = torch.where(img == cfg.num_imgs, torch.zeros_like(img), img)
    zero = torch.zeros_like(angles)
    return Candidates(torch.where(mask, angles, zero), torch.where(mask, distances, zero),
                      torch.where(mask, img, torch.zeros_like(img)), mask)


def init_waypoint_params(gen: torch.Generator, cfg: WaypointConfig,
                         depth_feat_dim: int = 128 * 4 * 4, device: DeviceLike = None) -> Params:
    """Random predictor parameters on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    d = cfg.hidden_dim
    per_img_angles = int(cfg.n_classes * (cfg.num_angles / cfg.num_imgs))
    return {
        "visual_fc_depth": init_dense(gen, depth_feat_dim, d, device),
        "bert_layers": [init_encoder_layer(gen, d, 4 * d, device) for _ in range(cfg.trm_layers)],
        "cls_fc1": init_dense(gen, d, d, device),
        "cls_fc2": init_dense(gen, d, per_img_angles, device),
    }
