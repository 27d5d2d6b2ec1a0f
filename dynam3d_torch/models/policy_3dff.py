"""3DFF pretraining policy: the 12-view panorama and its waypoint candidates;
port of ``models/policy_3dff.py``.

The 12 panorama views, reordered clockwise, feed the frozen depth encoder
and the waypoint predictor; views ``[0, 3, 6, 9]`` of that order (90-degree
fields, a full 360 together) feed CLIP and the memory update, each at
heading ``heading + view_id * (-pi / 6)``, after frustum deletion over
their full-resolution depth.  Candidates come from the NMS of the
heatmap; at train time the walk samples each candidate sector's
(angle, distance) bin from the sector's softmax instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.geom.projection import habitat_to_world
from dynam3d_torch.models.encoders import clip as clip_mod
from dynam3d_torch.models.encoders.depth_resnet import encode_depth, preprocess_depth
from dynam3d_torch.models.memory3d import delete_from_frustum
from dynam3d_torch.models.memory3d.pretrain import stack_aux, update_view_pretrain
from dynam3d_torch.models.memory3d.state import FieldState, stack_states, unstack_state
from dynam3d_torch.models.policy import nearest_resize_hw
from dynam3d_torch.models.segmenter import depth_plane_segments
from dynam3d_torch.models.waypoint.trm import Candidates, extract_candidates, predict_heatmap

Params = Dict[str, Any]

CLIP_VIEW_IDS = (0, 3, 6, 9)


def clockwise_reorder(x: torch.Tensor) -> torch.Tensor:
    """``[B, V, ...]`` views in the counter-clockwise sensor order ->
    clockwise: slot j takes sensor ``(V - j) % V``."""
    V = x.shape[1]
    idx = torch.tensor([(V - i) % V for i in range(V)], device=x.device)
    return x[:, idx]


def counter_clockwise_restore(x: torch.Tensor) -> torch.Tensor:
    """Undo :func:`clockwise_reorder`: keep view 0, reverse the rest."""
    return torch.cat([x[:, :1], torch.flip(x[:, 1:], dims=[1])], dim=1)


class PanoramaPerception(NamedTuple):
    state: FieldState
    aux: Any                       # PretrainAux, leading [B, 4]
    heatmap_logits: Any            # [B, 120, 12]; None without waypoints
    depth_feats: Any               # [B, 12, 128] pooled, counter-clockwise; likewise
    cls_fts: torch.Tensor          # [B, 4, D] CLIP CLS of the memory views


def _depth_features(params: Params, cfg: Dynam3DConfig, depth12: torch.Tensor) -> torch.Tensor:
    """Depth-encoder features ``[B * 12, F]`` of the clockwise panorama."""
    B = depth12.shape[0]
    d = clockwise_reorder(depth12)
    d = preprocess_depth(d.reshape(B * 12, *d.shape[2:])[..., None], (0.0, 10.0)) / 10.0
    return encode_depth(params["depth_enc"], cfg.depth, d)


def waypoint_heatmap(params: Params, cfg: Dynam3DConfig, depth12: torch.Tensor) -> torch.Tensor:
    """The frozen waypoint branch alone: normalized depth ``[B, 12, Hd, Wd]``
    (counter-clockwise) -> heatmap logits ``[B, 120, 12]``."""
    return predict_heatmap(params["waypoint"], cfg.waypoint, _depth_features(params, cfg, depth12))


def perceive_panorama(
    params: Params, cfg: Dynam3DConfig, state: FieldState,
    rgb12: torch.Tensor,                     # [B, 12, Hc, Wc, 3] uint8, counter-clockwise
    depth12: torch.Tensor,                   # [B, 12, Hd, Wd] normalized
    position_hab: torch.Tensor,              # [B, 3]
    heading: torch.Tensor,                   # [B]
    gt_xyz: Optional[torch.Tensor] = None,   # [B, G, 3]
    gt_label: Optional[torch.Tensor] = None,
    gt_valid: Optional[torch.Tensor] = None,
    with_waypoints: bool = True,
) -> PanoramaPerception:
    """Fold the four memory views of a panorama into the batched ``state``
    with the pretraining byproducts; with ``with_waypoints`` also the
    heatmap and the pooled depth features of all 12 views.  CLIP runs on
    the float32 pixels and its outputs are detached."""
    f = cfg.fields
    B = rgb12.shape[0]
    H, W = f.input_height, f.input_width
    HW = H * W
    dev = rgb12.device

    heatmap = depth_feats = None
    if with_waypoints:
        dfeats = _depth_features(params, cfg, depth12)
        heatmap = predict_heatmap(params["waypoint"], cfg.waypoint, dfeats)
        dfeats_ccw = counter_clockwise_restore(dfeats.reshape(B, 12, -1))
        depth_feats = dfeats_ccw.reshape(B, 12, 128, -1).mean(-1)

    view_ids = torch.tensor(CLIP_VIEW_IDS, device=dev)
    rgb4 = clockwise_reorder(rgb12)[:, view_ids]
    depth4 = clockwise_reorder(depth12)[:, view_ids]
    d24 = nearest_resize_hw(depth4, H, W)
    d24 = preprocess_depth(d24.reshape(B * 4, H, W)[..., None], (0.0, 10.0))[..., 0]
    d24 = d24.reshape(B, 4, HW)
    dfull = preprocess_depth(depth4.reshape(B * 4, *depth4.shape[2:])[..., None], (0.0, 10.0))
    dfull = dfull[..., 0].reshape(B, 4, *depth4.shape[2:])

    pixels = clip_mod.preprocess_rgb(rgb4.reshape(B * 4, *rgb4.shape[2:]), cfg.clip.image_size)
    cls_fts, grid = clip_mod.encode_image(params["clip"], cfg.clip, pixels)
    cls_fts = cls_fts.detach().reshape(B, 4, -1)
    grid = grid.detach().reshape(B, 4, HW, f.fts_dim)

    segm = depth_plane_segments(d24.reshape(B * 4, HW), H, W, f.max_segments).reshape(B, 4, HW)
    pos_world = habitat_to_world(position_hab.to(torch.float32))
    headings_v = heading.to(torch.float32)[:, None] \
        + view_ids[None, :].to(torch.float32) * (-math.pi / 6.0)

    if gt_xyz is None:
        gt_xyz = torch.zeros(B, 1, 3, device=dev)
        gt_label = torch.zeros(B, 1, dtype=torch.int32, device=dev)
        gt_valid = torch.zeros(B, 1, dtype=torch.bool, device=dev)

    states, auxes = [], []
    for b in range(B):
        st = unstack_state(state, b)
        for v in range(4):
            st = delete_from_frustum(st, f, dfull[b, v], pos_world[b], headings_v[b, v])
        view_aux = []
        for v in range(4):
            st, aux = update_view_pretrain(params["fields"], st, f, d24[b, v], grid[b, v],
                                           segm[b, v], pos_world[b], headings_v[b, v],
                                           gt_xyz[b], gt_label[b], gt_valid[b])
            view_aux.append(aux)
        states.append(st)
        auxes.append(stack_aux(view_aux))
    return PanoramaPerception(state=stack_states(states), aux=stack_aux(auxes),
                              heatmap_logits=heatmap, depth_feats=depth_feats, cls_fts=cls_fts)


def sample_waypoints_train(heatmap_logits: np.ndarray, nms_angle_idxes: list,
                           rng: np.random.Generator) -> Tuple[list, list]:
    """Waypoint augmentation: for each NMS candidate's sector, an
    (angle bin, distance bin) drawn with ``rng.choice`` from the sector's
    softmax, candidates in order.  ``heatmap_logits [B, 120, 12]`` carry the
    predictor's offset roll, undone here."""
    B = heatmap_logits.shape[0]
    regional = np.concatenate([heatmap_logits[:, -5:, :], heatmap_logits[:, :-5, :]],
                              axis=1).reshape(B, 12, 10, 12)
    out_a, out_d = [], []
    for j in range(B):
        angle_idxes = np.asarray(nms_angle_idxes[j], np.int64)
        img_idxes = (angle_idxes + 5) // 10
        img_idxes[img_idxes == 12] = 0
        sect = regional[j][img_idxes].reshape(len(img_idxes), -1)
        probs = np.exp(sect - sect.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        sa, sd = [], []
        for k in range(len(img_idxes)):
            act = rng.choice(120, p=probs[k])
            pointer = 0 if img_idxes[k] == 0 else (img_idxes[k] - 1) * 10 + 5
            sa.append(act // 12 + pointer)
            sd.append(act % 12)
        out_a.append(sa)
        out_d.append(sd)
    return out_a, out_d


def candidates_from_heatmap(cfg: Dynam3DConfig, heatmap_logits: torch.Tensor) -> Candidates:
    """NMS candidates of a heatmap, as the VLN path extracts them."""
    return extract_candidates(cfg.waypoint, heatmap_logits)
