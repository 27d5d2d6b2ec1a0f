"""Agent-relative instance / zone tokens of the 3D memory; port of
``models/memory3d/query.py::environment_features``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynam3d_torch.models.memory3d.state import FieldState


class EnvFeatures(NamedTuple):
    inst_fts: torch.Tensor       # [I,D]
    inst_rel_pos: torch.Tensor   # [I,3] agent frame
    inst_mask: torch.Tensor      # [I] valid and within instance_distance
    zone_fts: torch.Tensor       # [Z,D]
    zone_rel_pos: torch.Tensor   # [Z,3]
    zone_mask: torch.Tensor      # [Z]


def _relative(pos: torch.Tensor, camera: torch.Tensor, heading: torch.Tensor) -> torch.Tensor:
    h = -heading
    px = pos[:, 0] - camera[0]
    py = pos[:, 1] - camera[1]
    pz = pos[:, 2] - camera[2]
    rel_x = px * torch.cos(h) - py * torch.sin(h)
    rel_y = px * torch.sin(h) + py * torch.cos(h)
    return torch.stack([rel_x, rel_y, pz], dim=-1)


def environment_features(state: FieldState, camera_position: torch.Tensor,
                         heading: torch.Tensor, instance_distance: float = 5.0,
                         zone_distance: float = 100.0) -> EnvFeatures:
    inst_rel = _relative(state.inst_pos, camera_position, heading)
    inst_mask = state.inst_valid & (torch.linalg.norm(inst_rel, dim=-1) <= instance_distance)
    zone_rel = _relative(state.zone_pos, camera_position, heading)
    zone_mask = state.zone_valid & (torch.linalg.norm(zone_rel, dim=-1) <= zone_distance)
    return EnvFeatures(state.inst_fts, inst_rel, inst_mask, state.zone_fts, zone_rel, zone_mask)
