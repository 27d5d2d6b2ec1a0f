"""Fixed-capacity tables of the layered 3D memory (patches, instances,
zones) with validity masks; port of ``models/memory3d/state.py``.

Dead entries hold the -10000 tombstone position; ids are reused by the
smallest-free-slot rule.  A batched state carries a leading batch dim.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynam3d_torch.config import FieldsConfig

TOMBSTONE = -10000.0


class FieldState(NamedTuple):
    patch_pos: torch.Tensor      # [P,3] f32 world xyz (TOMBSTONE when dead)
    patch_fts: torch.Tensor      # [P,D] bf16
    patch_dir: torch.Tensor      # [P] f32
    patch_scale: torch.Tensor    # [P] f32
    patch_owner: torch.Tensor    # [P] i64 owning instance (-1 none)
    patch_valid: torch.Tensor    # [P] bool
    patch_step: torch.Tensor     # [P] i64 write-age stamp (eviction order)
    inst_pos: torch.Tensor       # [I,3] f32
    inst_fts: torch.Tensor       # [I,D] f32
    inst_valid: torch.Tensor     # [I] bool
    inst_gt_id: torch.Tensor     # [I] i64
    zone_key: torch.Tensor       # [Z,3] f32 cell-center key
    zone_pos: torch.Tensor       # [Z,3] f32
    zone_fts: torch.Tensor       # [Z,D] f32
    zone_valid: torch.Tensor     # [Z] bool


def init_state(cfg: FieldsConfig, device, fts_dtype=torch.bfloat16) -> FieldState:
    P, I, Z, D = cfg.patch_capacity, cfg.instance_capacity, cfg.zone_capacity, cfg.fts_dim

    def full(shape, v, dt=torch.float32):
        return torch.full(shape, v, dtype=dt, device=device)

    return FieldState(
        patch_pos=full((P, 3), TOMBSTONE),
        patch_fts=torch.zeros((P, D), dtype=fts_dtype, device=device),
        patch_dir=full((P,), 0.0),
        patch_scale=full((P,), 0.0),
        patch_owner=full((P,), -1, torch.int64),
        patch_valid=full((P,), False, torch.bool),
        patch_step=full((P,), 0, torch.int64),
        inst_pos=full((I, 3), TOMBSTONE),
        inst_fts=full((I, D), 0.0),
        inst_valid=full((I,), False, torch.bool),
        inst_gt_id=full((I,), -1, torch.int64),
        zone_key=full((Z, 3), TOMBSTONE),
        zone_pos=full((Z, 3), TOMBSTONE),
        zone_fts=full((Z, D), 0.0),
        zone_valid=full((Z,), False, torch.bool),
    )


def cell_center(pos: torch.Tensor, cfg: FieldsConfig) -> torch.Tensor:
    """Zone cell-center key ``floor(p / l) * l + l / 2`` of ``[..., 3]``."""
    lens = torch.tensor([cfg.zone_x_length, cfg.zone_y_length, cfg.zone_z_length],
                        dtype=torch.float32, device=pos.device)
    return torch.floor(pos / lens) * lens + lens / 2.0


def stack_states(states) -> FieldState:
    return FieldState(*(torch.stack(ts) for ts in zip(*states)))


def unstack_state(state: FieldState, b: int) -> FieldState:
    return FieldState(*(t[b] for t in state))
