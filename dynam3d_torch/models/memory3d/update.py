"""The layer-wise 3D memory update; port of ``models/memory3d/update.py``
(``update_view``, ``update_views``, ``delete_from_frustum``).

Semantics kept from the reference package: smallest-free-slot allocation,
oldest-first patch eviction on overflow, the -10000 tombstone, block-diagonal
per-segment aggregation, batched merge proposals against the pre-view
instance table and one re-aggregation per merged instance with its final
membership.

Two PyTorch-specific points:

* The reference's ``mode="drop"`` scatters address row ``capacity`` to mean
  "no write"; PyTorch would fault on that index.  :func:`scatter_drop`
  writes through a spare sentinel row that is sliced off.
* The re-aggregation encoders only compute what the tables keep: the rows
  of instances / zones that are written and the member columns up to the
  largest live membership.  Masked member keys contribute exact zeros to
  the softmax and only the [AGG] token's output is read, so the kept
  values are the same as over the full padded ``[max_segments,
  1 + max_members]`` block (whose attention logits alone would take
  ~50 GB at full width).  Their gradients are the same too: a dropped row
  or column reaches no kept value, and every write is an index write into
  a fresh tensor, which autograd follows.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from dynam3d_torch.config import FieldsConfig
from dynam3d_torch.geom.projection import frustum_mask_habitat, unproject_depth_habitat
from dynam3d_torch.models.memory3d.state import TOMBSTONE, FieldState, cell_center
from dynam3d_torch.ops.knn import knn_brute
from dynam3d_torch.ops.segment import first_free_slots, segment_mean
from dynam3d_torch.ops.transformer import dense, encoder_stack, gelu, layer_norm, mlp2
from dynam3d_torch.runtime import profiling

Params = Dict[str, Any]
_DEAD = 1e6
_PAD_CELL = 1e9


class ViewAux(NamedTuple):
    seg_fts: torch.Tensor
    seg_center: torch.Tensor
    seg_active: torch.Tensor
    merge_logits: torch.Tensor
    merge_inds: torch.Tensor
    is_merge: torch.Tensor
    owner: torch.Tensor
    patch_slots: torch.Tensor


def scatter_drop(table: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``table.at[idx].set(values, mode="drop")``: rows with
    ``idx == len(table)`` are not written.  Returns a new tensor."""
    cap = table.shape[0]
    ext = torch.cat([table, table[:1]], dim=0)
    ext[idx.clamp(0, cap)] = values if torch.is_tensor(values) else torch.as_tensor(
        values, dtype=table.dtype, device=table.device)
    return ext[:cap]


def _num_heads(d: int) -> int:
    return max(1, d // 64)


def _patch_pos_embedding_input(pos, center, direction, scale) -> torch.Tensor:
    """7-dim embedding input; the distance is the norm of the ABSOLUTE
    patch position, as in the reference."""
    rel = pos - center
    dist = torch.linalg.norm(pos, dim=-1, keepdim=True)
    return torch.cat([rel, dist, torch.sin(direction)[..., None],
                      torch.cos(direction)[..., None], scale[..., None]], dim=-1)


def _merge_discriminator(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(p["ln"], dense(p["fc1"], x))
    return dense(p["fc2"], gelu(h))


def _first_k_true(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = first_free_slots(~mask, k)
    n = mask.sum()
    return idx, torch.arange(k, device=mask.device) < n


def _enc_dtype(cfg: FieldsConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.encoder_dtype == "bf16" else torch.float32


def update_view(
    params: Params, state: FieldState, cfg: FieldsConfig, depth: torch.Tensor,
    grid_fts: torch.Tensor, segm: torch.Tensor, position: torch.Tensor,
    heading: torch.Tensor, seg_gt_id: Optional[torch.Tensor] = None,
    geometry: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[FieldState, ViewAux]:
    """Fold one view (``depth [HW]``, ``grid_fts [HW, D]``, ``segm [HW]``,
    world ``position [3]``, scalar ``heading``) into one episode's memory.

    ``seg_gt_id [S]`` (pretraining) is recorded on new instances;
    ``geometry = (ppos [HW, 3], pdir [HW], pscale [HW])`` replaces the
    habitat unprojection (posed frames).  The stored instance and zone
    features enter detached, so a gradient reaches ``params`` only through
    this view's writes."""
    H, W, D = cfg.input_height, cfg.input_width, cfg.fts_dim
    HW = H * W
    S = cfg.max_segments
    K = cfg.num_proposal_instances
    heads = _num_heads(D)
    dev = depth.device
    enc_dt = _enc_dtype(cfg)
    segm = segm.to(torch.int64)
    state = state._replace(inst_fts=state.inst_fts.detach(), zone_fts=state.zone_fts.detach())

    # ---- 1. unproject ----
    if geometry is None:
        rel_x, rel_y, rel_z, pdir, pscale = unproject_depth_habitat(
            depth, heading, height=H, width=W,
            hfov_deg=cfg.input_hfov, vfov_deg=cfg.input_vfov,
        )
        ppos = torch.stack([rel_x, rel_y, rel_z], -1) + position[None, :]
    else:
        ppos, pdir, pscale = geometry

    # ---- 2. write patches into free slots, oldest evicted first ----
    P_cap = cfg.patch_capacity
    stamp = state.patch_step.max() + 1
    ar_p = torch.arange(P_cap, device=dev)
    alloc_key = torch.where(state.patch_valid, (state.patch_step + 1) * P_cap, 0) + ar_p
    slots = torch.topk(alloc_key, HW, largest=False).indices.sort().values
    evicted = state.patch_valid[slots]
    patch_owner = state.patch_owner.clone()
    patch_owner[slots] = torch.where(evicted, -1, patch_owner[slots])
    patch_pos = state.patch_pos.clone()
    patch_pos[slots] = ppos
    patch_fts = state.patch_fts.clone()
    patch_fts[slots] = grid_fts.to(patch_fts.dtype)
    patch_dir = state.patch_dir.clone()
    patch_dir[slots] = pdir
    patch_scale = state.patch_scale.clone()
    patch_scale[slots] = pscale
    patch_valid = state.patch_valid.clone()
    patch_valid[slots] = True
    patch_step = state.patch_step.clone()
    patch_step[slots] = stamp

    # ---- 3. per-segment aggregation (block-diagonal attention) ----
    centers, counts = segment_mean(ppos, segm, S)
    seg_active = counts > 0
    emb_in = _patch_pos_embedding_input(ppos, centers[segm], pdir, pscale)
    patch_tokens = grid_fts.to(torch.float32) + mlp2(params["patch_pos_mlp"], emb_in)
    agg = params["p2i_agg_token"].expand(S, D)
    tokens = torch.cat([agg, patch_tokens], dim=0)
    group = torch.cat([torch.arange(S, device=dev), segm])
    block_mask = group[:, None] == group[None, :]
    out = encoder_stack(params["p2i_encoder"], tokens.to(enc_dt), heads, attn_mask=block_mask)
    seg_fts = out[:S].to(torch.float32)

    # ---- 4. merge proposals against the pre-view instance table ----
    sq_d, inds = knn_brute(centers, state.inst_pos, state.inst_valid, K)
    col_dead = ((sq_d >= _DEAD) & seg_active[:, None]).any(dim=0)
    col_ok = torch.cumsum(col_dead.to(torch.int64), 0) == 0
    prop_pos = state.inst_pos[inds]
    prop_fts = state.inst_fts[inds]
    disc_in = torch.cat([prop_fts, seg_fts[:, None, :].expand_as(prop_fts),
                         centers[:, None, :] - prop_pos], dim=-1)
    merge_logits = _merge_discriminator(params["merge_disc"], disc_in)
    merge_flag = (merge_logits.argmax(-1) == 1) & col_ok[None, :] & seg_active[:, None]
    is_merge = merge_flag.any(-1)
    first_flag = merge_flag.to(torch.int64).argmax(-1)
    merge_target = torch.gather(inds, 1, first_flag[:, None])[:, 0]

    # ---- 5. allocate new instances, assign owners ----
    I_cap = cfg.instance_capacity
    is_new = seg_active & ~is_merge
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    free_inst = first_free_slots(state.inst_valid, S)
    new_ids = free_inst[new_rank.clamp(0, S - 1)]
    owner = torch.where(is_merge, merge_target, new_ids)
    owner = torch.where(seg_active, owner, -1)
    new_write = torch.where(is_new, new_ids, I_cap)
    inst_pos = scatter_drop(state.inst_pos, new_write, centers)
    inst_fts = scatter_drop(state.inst_fts, new_write, seg_fts.to(state.inst_fts.dtype))
    inst_valid = scatter_drop(state.inst_valid, new_write, True)
    inst_gt_id = state.inst_gt_id
    if seg_gt_id is not None:
        inst_gt_id = scatter_drop(inst_gt_id, new_write, seg_gt_id.to(inst_gt_id.dtype))
    patch_owner[slots] = owner[segm]

    # ---- 6. re-aggregate merged instances with their final membership ----
    merged_mask = scatter_drop(
        torch.zeros(I_cap, dtype=torch.bool, device=dev),
        torch.where(is_merge, merge_target, I_cap), True)
    merge_ids, merge_fill = _first_k_true(merged_mask, S)
    profiling.count("sync")
    n_fill = int(merge_fill.sum())
    if n_fill:
        ids = merge_ids[:n_fill]
        member_of = (patch_owner[None, :] == ids[:, None]) & patch_valid[None, :]
        mkeys = torch.where(member_of, ar_p[None, :], P_cap)
        mslots = torch.sort(mkeys, dim=1).values[:, : cfg.max_members]
        mva = mslots < P_cap
        profiling.count("sync")
        tm = max(1, int(mva.sum(1).max()))
        mslots, mva = mslots[:, :tm], mva[:, :tm]
        msl_c = mslots.clamp(max=P_cap - 1)
        mpos = patch_pos[msl_c]
        mfts = patch_fts[msl_c].to(torch.float32)
        mcount = torch.clamp(mva.sum(1), min=1)
        nc = torch.where(mva[..., None], mpos, 0.0).sum(1) / mcount[:, None]
        memb_in = _patch_pos_embedding_input(mpos, nc[:, None, :], patch_dir[msl_c],
                                             patch_scale[msl_c])
        mtokens = mfts + mlp2(params["patch_pos_mlp"], memb_in)
        magg = params["p2i_agg_token"].expand(n_fill, 1, D)
        mtokens = torch.cat([magg, mtokens], dim=1)
        kp = torch.cat([torch.ones(n_fill, 1, dtype=torch.bool, device=dev), mva], dim=1)
        mout = encoder_stack(params["p2i_encoder"], mtokens.to(enc_dt), heads,
                             key_padding_mask=kp)
        inst_pos = inst_pos.clone()
        inst_fts = inst_fts.clone()
        inst_pos[ids] = nc
        inst_fts[ids] = mout[:, 0].to(torch.float32).to(inst_fts.dtype)

    # ---- 7. zones of the cells touched by this view's segment centers ----
    seg_cells = torch.where(seg_active[:, None], cell_center(centers, cfg),
                            torch.full_like(centers, _PAD_CELL))
    profiling.count("sync")
    cells = torch.unique(seg_cells, dim=0, sorted=True)
    if cells.shape[0] < S:
        cells = torch.cat([cells, torch.full((S - cells.shape[0], 3), _PAD_CELL,
                                             dtype=cells.dtype, device=dev)])
    cell_real = cells[:, 0] < _PAD_CELL / 2
    key_eq = ((cells[:, None, :] - state.zone_key[None]).abs() < 1e-4).all(-1) \
        & state.zone_valid[None, :]
    zone_exists = key_eq.any(1)
    existing_id = key_eq.to(torch.int64).argmax(1)
    inst_cells = cell_center(inst_pos, cfg)
    zmember = ((cells[:, None, :] - inst_cells[None]).abs() < 1e-4).all(-1) \
        & inst_valid[None, :] & cell_real[:, None]
    is_new_zone = cell_real & ~zone_exists & zmember.any(1)
    z_rank = torch.cumsum(is_new_zone.to(torch.int64), 0) - 1
    free_zone = first_free_slots(state.zone_valid, S)
    zid = torch.where(zone_exists, existing_id, free_zone[z_rank.clamp(0, S - 1)])
    do_write = cell_real & zmember.any(1)

    zone_key, zone_pos, zone_fts, zone_valid = (
        state.zone_key, state.zone_pos, state.zone_fts, state.zone_valid)
    profiling.count("sync")
    rows = torch.nonzero(do_write).flatten()
    if rows.numel():
        zm = zmember[rows]
        ar_i = torch.arange(I_cap, device=dev)
        zslots = torch.sort(torch.where(zm, ar_i[None, :], I_cap), dim=1).values
        zslots = zslots[:, : cfg.max_zone_members]
        zvalid_m = zslots < I_cap
        profiling.count("sync")
        km = max(1, int(zvalid_m.sum(1).max()))
        zslots, zvalid_m = zslots[:, :km], zvalid_m[:, :km]
        zslots_c = zslots.clamp(max=I_cap - 1)
        z_inst_pos = inst_pos[zslots_c]
        z_inst_fts = inst_fts[zslots_c].to(torch.float32)
        zcount = zvalid_m.sum(1)
        cells_w = cells[rows]
        member_pos_eff = torch.where(zone_exists[rows][:, None, None],
                                     cells_w[:, None, :], z_inst_pos)
        zpos_new = torch.where(zvalid_m[..., None], member_pos_eff, 0.0).sum(1) \
            / torch.clamp(zcount, min=1)[:, None]
        z_rel = member_pos_eff - zpos_new[:, None, :]
        z_dist = torch.linalg.norm(member_pos_eff, dim=-1, keepdim=True)
        ztokens = z_inst_fts + mlp2(params["inst_pos_mlp"], torch.cat([z_rel, z_dist], -1))
        n_w = rows.numel()
        zagg = params["i2z_agg_token"].expand(n_w, 1, D)
        ztokens = torch.cat([zagg, ztokens], dim=1)
        zkp = torch.cat([torch.ones(n_w, 1, dtype=torch.bool, device=dev), zvalid_m], 1)
        zout = encoder_stack(params["i2z_encoder"], ztokens.to(enc_dt), heads,
                             key_padding_mask=zkp)
        zw = zid[rows]
        zone_key, zone_pos = zone_key.clone(), zone_pos.clone()
        zone_fts, zone_valid = zone_fts.clone(), zone_valid.clone()
        zone_key[zw] = cells_w
        zone_pos[zw] = zpos_new
        zone_fts[zw] = zout[:, 0].to(torch.float32).to(zone_fts.dtype)
        zone_valid[zw] = True

    new_state = FieldState(
        patch_pos, patch_fts, patch_dir, patch_scale, patch_owner, patch_valid,
        patch_step, inst_pos, inst_fts, inst_valid, inst_gt_id, zone_key,
        zone_pos, zone_fts, zone_valid,
    )
    aux = ViewAux(seg_fts, centers, seg_active,
                  merge_logits[..., 1] - merge_logits[..., 0], inds, is_merge,
                  owner, slots)
    return new_state, aux


def update_views(params: Params, state: FieldState, cfg: FieldsConfig,
                 depth: torch.Tensor, grid_fts: torch.Tensor, segm: torch.Tensor,
                 position: torch.Tensor, headings: torch.Tensor) -> FieldState:
    """Fold V views in order (``[V, HW]``, ``[V, HW, D]``, ``[V, HW]``,
    ``[V]``): later views see earlier views' instances."""
    for v in range(depth.shape[0]):
        state, _ = update_view(params, state, cfg, depth[v], grid_fts[v], segm[v],
                               position, headings[v])
    return state


def delete_from_frustum(state: FieldState, cfg: FieldsConfig, depth: torch.Tensor,
                        position: torch.Tensor, heading: torch.Tensor) -> FieldState:
    """Forget memory inside the current camera frustum: tombstone visible
    patches, then instances that lost all patches, then zones keyed by a
    dead instance's cell that have no instance left."""
    I = cfg.instance_capacity
    dh, dw = depth.shape
    doomed = frustum_mask_habitat(
        state.patch_pos, depth, position, heading, height=dh, width=dw,
        hfov_deg=cfg.input_hfov, vfov_deg=cfg.input_vfov, near=0.0,
        far=cfg.deleted_frustum_distance, depth_slack=cfg.frustum_depth_slack,
    ) & state.patch_valid

    patch_valid = state.patch_valid & ~doomed
    patch_pos = torch.where(doomed[:, None], TOMBSTONE, state.patch_pos)
    patch_fts = torch.where(doomed[:, None], torch.zeros_like(state.patch_fts), state.patch_fts)
    patch_dir = torch.where(doomed, 0.0, state.patch_dir)
    patch_scale = torch.where(doomed, 0.0, state.patch_scale)
    patch_owner = torch.where(doomed, -1, state.patch_owner)

    own = torch.where(patch_valid, patch_owner, I).clamp(0, I)
    live_counts = torch.bincount(own, minlength=I + 1)[:I]
    inst_dead = state.inst_valid & (live_counts == 0)
    hit = torch.where(doomed, state.patch_owner, I).clamp(0, I)
    touched = torch.bincount(hit, minlength=I + 1)[:I] > 0
    inst_dead = inst_dead & touched

    inst_valid = state.inst_valid & ~inst_dead
    inst_pos = torch.where(inst_dead[:, None], TOMBSTONE, state.inst_pos)
    inst_fts = torch.where(inst_dead[:, None], torch.zeros_like(state.inst_fts), state.inst_fts)
    inst_gt_id = torch.where(inst_dead, -10000, state.inst_gt_id)

    dead_cells = cell_center(state.inst_pos, cfg)
    zone_touched = (((state.zone_key[:, None, :] - dead_cells[None]).abs() < 1e-4).all(-1)
                    & inst_dead[None, :]).any(1) & state.zone_valid
    live_cells = cell_center(inst_pos, cfg)
    members_left = (((state.zone_key[:, None, :] - live_cells[None]).abs() < 1e-4).all(-1)
                    & inst_valid[None, :]).sum(1)
    zone_dead = zone_touched & (members_left == 0)
    zone_valid = state.zone_valid & ~zone_dead
    zone_key = torch.where(zone_dead[:, None], TOMBSTONE, state.zone_key)
    zone_pos = torch.where(zone_dead[:, None], TOMBSTONE, state.zone_pos)
    zone_fts = torch.where(zone_dead[:, None], torch.zeros_like(state.zone_fts), state.zone_fts)

    return FieldState(
        patch_pos, patch_fts, patch_dir, patch_scale, patch_owner, patch_valid,
        state.patch_step, inst_pos, inst_fts, inst_valid, inst_gt_id, zone_key,
        zone_pos, zone_fts, zone_valid,
    )
