"""Pretraining-mode memory update: the byproducts and ground-truth signals
the 3DFF losses read; port of ``models/memory3d/pretrain.py``.

Per view: per-segment gt instance ids by a 1-NN majority vote against the
scene's gt point cloud; instance alignment targets (segment-mean CLIP
features, the view mean); a pseudo-zone prediction of all segments against
the view's CLIP CLS feature; merge-discriminator targets against the
pre-view gt-id table; the updated instances' features and gt ids; the
touched zones' features and member gt ids.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from dynam3d_torch.config import FieldsConfig
from dynam3d_torch.geom.projection import unproject_depth_habitat
from dynam3d_torch.models.memory3d.state import FieldState, cell_center
from dynam3d_torch.models.memory3d.update import ViewAux, _num_heads, update_view
from dynam3d_torch.ops.knn import knn_brute
from dynam3d_torch.ops.segment import segment_mean
from dynam3d_torch.ops.transformer import encoder_stack, mlp2

Params = Dict[str, Any]
_PAD_CELL = 1e9


class PretrainAux(NamedTuple):
    base: ViewAux
    seg_gt_id: torch.Tensor            # [S] majority-vote gt instance id (-1 inactive)
    target_seg_fts: torch.Tensor       # [S, D] mean member-patch CLIP features
    patch_mean_fts: torch.Tensor       # [D] view-mean CLIP feature
    zone_pred_fts: torch.Tensor        # [D] this view's pseudo-zone prediction
    merge_target: torch.Tensor         # [S, K] 1 where the proposal shares the gt id
    merge_valid: torch.Tensor          # [S, K] supervision validity
    inst_pred_fts: torch.Tensor        # [S, D] updated features of touched instances
    inst_pred_gt: torch.Tensor         # [S] their gt ids (-1 invalid)
    zone_member_gt: torch.Tensor       # [S, Kz] member gt ids of touched zones
    zone_pred_zone_fts: torch.Tensor   # [S, D] updated features of touched zones
    zone_touch_valid: torch.Tensor     # [S]


def stack_aux(auxes) -> PretrainAux:
    """Per-view aux records -> one record with a leading ``[V]`` axis."""
    base = ViewAux(*(torch.stack(ts) for ts in zip(*(a.base for a in auxes))))
    rest = [torch.stack(ts) for ts in zip(*(a[1:] for a in auxes))]
    return PretrainAux(base, *rest)


def unstack_aux(aux: PretrainAux, b: int) -> PretrainAux:
    """Element ``b`` of a record with a leading axis."""
    return PretrainAux(ViewAux(*(t[b] for t in aux.base)), *(t[b] for t in aux[1:]))


def segment_gt_ids(segm: torch.Tensor, patch_pos: torch.Tensor, gt_xyz: torch.Tensor,
                   gt_label: torch.Tensor, gt_valid: torch.Tensor, max_segments: int,
                   max_label: int) -> torch.Tensor:
    """Per-segment majority-vote gt instance id (first label on a tie),
    -1 for a segment without patches."""
    _, nn = knn_brute(patch_pos, gt_xyz, gt_valid, 1)
    labels = torch.clamp(gt_label[nn[:, 0]].to(torch.int64), 0, max_label - 1)
    counts = torch.bincount(segm.to(torch.int64) * max_label + labels,
                            minlength=max_segments * max_label).reshape(max_segments, max_label)
    maj = torch.argmax(counts, dim=-1)
    return torch.where(counts.sum(-1) > 0, maj, torch.full_like(maj, -1))


def update_view_pretrain(
    params: Params, state: FieldState, cfg: FieldsConfig, depth: torch.Tensor,
    grid_fts: torch.Tensor, segm: torch.Tensor, position: torch.Tensor,
    heading: torch.Tensor, gt_xyz: Optional[torch.Tensor] = None,
    gt_label: Optional[torch.Tensor] = None, gt_valid: Optional[torch.Tensor] = None,
    max_gt_label: int = 512, geometry=None,
) -> Tuple[FieldState, PretrainAux]:
    """:func:`update_view` plus the pretraining byproducts of the view."""
    S = cfg.max_segments
    heads = _num_heads(cfg.fts_dim)
    dev = depth.device
    segm = segm.to(torch.int64)

    if geometry is None:
        rel_x, rel_y, rel_z, _, _ = unproject_depth_habitat(
            depth, heading, height=cfg.input_height, width=cfg.input_width,
            hfov_deg=cfg.input_hfov, vfov_deg=cfg.input_vfov)
        ppos = torch.stack([rel_x, rel_y, rel_z], -1) + position[None, :]
    else:
        ppos = geometry[0]

    if gt_xyz is not None:
        seg_gt = segment_gt_ids(segm, ppos, gt_xyz, gt_label, gt_valid, S, max_gt_label)
    else:
        seg_gt = torch.full((S,), -1, dtype=torch.int64, device=dev)

    pre_state = state
    new_state, aux = update_view(params, state, cfg, depth, grid_fts, segm, position, heading,
                                 seg_gt_id=seg_gt, geometry=geometry)

    target_seg_fts, _ = segment_mean(grid_fts.to(torch.float32), segm, S)
    patch_mean = grid_fts.to(torch.float32).mean(dim=0)

    # per-view pseudo-zone prediction against the CLIP CLS feature
    centers = aux.seg_center
    act_f = aux.seg_active
    mean_center = torch.where(act_f[:, None], centers, torch.zeros_like(centers)).sum(0) \
        / torch.clamp(act_f.sum(), min=1)
    emb = torch.cat([centers - mean_center, torch.linalg.norm(centers, dim=-1, keepdim=True)], -1)
    ztokens = aux.seg_fts + mlp2(params["inst_pos_mlp"], emb)
    ztokens = torch.cat([params["i2z_agg_token"], ztokens], dim=0)
    kp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), aux.seg_active])
    zone_pred = encoder_stack(params["i2z_encoder"], ztokens, heads, key_padding_mask=kp)[0]

    # merge supervision against the pre-view gt-id table
    prop_gt = pre_state.inst_gt_id[aux.merge_inds]
    merge_target = (prop_gt == seg_gt[:, None]) & (seg_gt[:, None] >= 0)
    merge_valid = (aux.seg_active[:, None] & (seg_gt[:, None] >= 0) & (aux.merge_inds >= 0)
                   & pre_state.inst_valid[torch.clamp(aux.merge_inds, min=0)])

    own = torch.clamp(aux.owner, min=0)
    inst_pred_fts = new_state.inst_fts[own]
    inst_pred_gt = torch.where(aux.seg_active, new_state.inst_gt_id[own],
                               torch.full_like(own, -1))

    # touched zones and their members' gt ids
    seg_cells = torch.where(aux.seg_active[:, None], cell_center(centers, cfg),
                            torch.full_like(centers, _PAD_CELL))
    cells = torch.unique(seg_cells, dim=0, sorted=True)
    if cells.shape[0] < S:
        cells = torch.cat([cells, cells.new_full((S - cells.shape[0], 3), _PAD_CELL)])
    cell_real = cells[:, 0] < 5e8
    key_eq = ((cells[:, None, :] - new_state.zone_key[None]).abs() < 1e-4).all(-1) \
        & new_state.zone_valid[None, :]
    z_exists = key_eq.any(1) & cell_real
    zid = key_eq.to(torch.int64).argmax(1)
    zone_pred_zone_fts = new_state.zone_fts[zid]
    inst_cells = cell_center(new_state.inst_pos, cfg)
    member = ((cells[:, None, :] - inst_cells[None]).abs() < 1e-4).all(-1) \
        & new_state.inst_valid[None, :]
    I = member.shape[1]
    ar = torch.arange(I, device=dev)
    mslots = torch.sort(torch.where(member, ar[None, :], I), dim=1).values[:, : cfg.max_zone_members]
    mvalid = mslots < I
    mgt = torch.where(mvalid, new_state.inst_gt_id[torch.clamp(mslots, max=I - 1)],
                      torch.full_like(mslots, -1))

    return new_state, PretrainAux(
        base=aux, seg_gt_id=seg_gt, target_seg_fts=target_seg_fts, patch_mean_fts=patch_mean,
        zone_pred_fts=zone_pred, merge_target=merge_target.to(torch.int64),
        merge_valid=merge_valid, inst_pred_fts=inst_pred_fts, inst_pred_gt=inst_pred_gt,
        zone_member_gt=mgt, zone_pred_zone_fts=zone_pred_zone_fts, zone_touch_valid=z_exists,
    )
