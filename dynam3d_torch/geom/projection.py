"""Depth unprojection and frustum culling for the serving step.

Port of ``geom/projection.py``: ``unproject_depth_habitat``,
``patch_3d_info``, ``habitat_to_world`` and ``frustum_mask_habitat``, with
the same pixel-grid conventions (half-pixel offsets, row-major flattening,
z-up flips).  All math is full float32 and elementwise; the callers pin
TF32 off on the card (:func:`dynam3d_torch.device.pin_full_fp32`).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _tan_grid_x(height: int, width: int, hfov_deg: float) -> np.ndarray:
    """Per-pixel horizontal tangent, flattened row-major over HxW."""
    half_w = width // 2
    col = np.array([i / half_w + 1.0 / width for i in range(-half_w, half_w)], np.float32)
    return np.tile(col, height) * math.tan(math.pi * hfov_deg / 360.0)


def _tan_grid_z(height: int, width: int, vfov_deg: float) -> np.ndarray:
    """Per-pixel vertical tangent (z-up), flattened row-major over HxW."""
    half_h = height // 2
    row = np.array([i / half_h - 1.0 / height for i in range(half_h, -half_h, -1)], np.float32)
    return np.repeat(row, width) * math.tan(math.pi * vfov_deg / 360.0)


def _grid(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.float32), device=like.device)


def unproject_depth_habitat(
    depth: torch.Tensor, heading: torch.Tensor, *, height: int, width: int,
    hfov_deg: float = 90.0, vfov_deg: float = 90.0,
) -> Tuple[torch.Tensor, ...]:
    """``depth [..., H*W]`` and heading ``[...]`` -> agent-relative world
    offsets ``(rel_x, rel_y, rel_z, direction, scale)``, each ``[..., H*W]``."""
    tan_xy = _grid(_tan_grid_x(height, width, hfov_deg), depth)
    tan_z = _grid(_tan_grid_z(height, width, vfov_deg), depth)
    depth_y = depth.to(torch.float32)
    depth_x = depth_y * tan_xy
    depth_z = depth_y * tan_z
    scale = depth_y * (math.tan(math.pi * hfov_deg / 360.0) * 2.0 / width)
    heading = torch.as_tensor(heading, dtype=torch.float32, device=depth.device)
    direction = torch.remainder(-torch.arctan(tan_xy) + heading[..., None], 2.0 * math.pi)
    cos_h = torch.cos(heading)[..., None]
    sin_h = torch.sin(heading)[..., None]
    rel_x = depth_x * cos_h - depth_y * sin_h
    rel_y = depth_x * sin_h + depth_y * cos_h
    return rel_x, rel_y, depth_z, direction, scale


def patch_3d_info(
    depth: torch.Tensor, *, height: int, width: int,
    hfov_deg: float = 90.0, vfov_deg: float = 90.0,
) -> Tuple[torch.Tensor, ...]:
    """Camera-frame per-patch ``(x, y, z, direction, scale)`` of a view."""
    tan_xy = _grid(_tan_grid_x(height, width, hfov_deg), depth)
    tan_z = _grid(_tan_grid_z(height, width, vfov_deg), depth)
    depth_y = depth.to(torch.float32)
    depth_x = depth_y * tan_xy
    depth_z = depth_y * tan_z
    scale = depth_y * (math.tan(math.pi * hfov_deg / 360.0) * 2.0 / width)
    direction = torch.remainder(-torch.arctan(tan_xy), 2.0 * math.pi)
    direction = direction.expand(depth_y.shape)
    return depth_x, depth_y, depth_z, direction, scale


def habitat_to_world(position: torch.Tensor) -> torch.Tensor:
    """Habitat (x, y-up, z) -> world (x, -z, y)."""
    return torch.stack([position[..., 0], -position[..., 2], position[..., 1]], dim=-1)


def frustum_mask_habitat(
    points: torch.Tensor, depth_map: torch.Tensor, camera_position: torch.Tensor,
    heading: torch.Tensor, *, height: int, width: int, hfov_deg: float = 90.0,
    vfov_deg: float = 90.0, near: float = 0.0, far: float = 3.0,
    depth_slack: float = 0.1,
) -> torch.Tensor:
    """``[N]`` bool: world points inside the camera frustum and in front of
    the observed depth (the points to forget)."""
    fx = width / math.tan(math.radians(hfov_deg) / 2.0) / 2.0
    fy = height / math.tan(math.radians(vfov_deg) / 2.0) / 2.0
    h = -torch.as_tensor(heading, dtype=torch.float32, device=points.device)
    px = points[:, 0] - camera_position[0]
    py = points[:, 1] - camera_position[1]
    pz = points[:, 2] - camera_position[2]
    rel_x = px * torch.cos(h) - py * torch.sin(h)
    rel_y = px * torch.sin(h) + py * torch.cos(h)
    vx, vy, vz = rel_x, -pz, rel_y
    u = (fx * vx + (width / 2.0) * vz) / vz
    v = (fy * vy + (height / 2.0) * vz) / vz
    # truncation toward zero like torch .to(int64); non-finite -> int min,
    # which every bound test below rejects
    u_i = _trunc_i32(u)
    v_i = _trunc_i32(v)
    depth = vz
    in_frustum = (
        (depth >= near) & (depth <= far) & (u_i >= 0) & (u_i <= width - 1)
        & (v_i >= 0) & (v_i <= height - 1)
    )
    u_w = torch.clamp(torch.remainder(u_i.abs(), width), 0, width - 1)
    v_w = torch.clamp(torch.remainder(v_i.abs(), height), 0, height - 1)
    camera_depth = depth_map[v_w.long(), u_w.long()]
    return in_frustum & (depth < camera_depth + depth_slack)


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncation with XLA's saturating semantics: NaN -> 0,
    out-of-range values clamp to the int32 limits."""
    t = torch.trunc(torch.nan_to_num(x, nan=0.0))
    t = torch.clamp(t, -2147483648.0, 2147483520.0)
    return t.to(torch.int32)
