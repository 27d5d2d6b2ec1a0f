"""Depth unprojection, frustum culling and render ray grids.

Port of ``geom/projection.py``: ``unproject_depth_habitat``,
``patch_3d_info``, ``habitat_to_world`` and ``frustum_mask_habitat`` for the
serving step; the renderer's ray grids (``ray_grid_habitat``,
``ray_grid_intrinsics``, ``single_distance_ray_grid``) and the posed-frame geometry
(``unproject_depth_intrinsics``, ``scale_intrinsics``,
``patch_geometry_from_pose``, ``camera_heading_from_rotation``, ``view_k``)
for 3DFF pretraining; with the same pixel-grid conventions (half-pixel
offsets, row-major flattening, z-up flips).  All math is full float32; the
callers pin TF32 off on the card (:func:`dynam3d_torch.device.pin_full_fp32`).
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


def heading_from_positions(position: torch.Tensor) -> torch.Tensor:
    """World-frame heading angle of displacement vectors ``[..., 3]``, with
    the reference's transposed-axis quirk and its ``dy < 0`` branch."""
    dx = position[..., 0]
    dy = position[..., 1]
    xy_dist = torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-4)
    heading = -torch.arcsin(dx / xy_dist)
    return torch.where(dy < 0, heading - math.pi, heading)


def ray_grid_habitat(
    *, height: int, width: int, hfov_deg: float = 90.0, vfov_deg: float = 90.0,
    near: float = 0.0, far: float = 10.0, n_samples: int = 501,
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], np.ndarray, np.ndarray]:
    """Camera-frame ray sample grid of the habitat renderer (numpy, static).

    Returns ``((rel_x, rel_y, rel_z), rel_direction, rel_dist)``: each
    ``[H*W, n_samples]``, the direction ``[H*W, 1]``; ``n_samples`` uniform
    depths in ``[near, far]``."""
    hw = height * width
    rel_y = np.tile(np.linspace(near, far, n_samples, dtype=np.float32)[None, :], (hw, 1))
    tan_xy = _tan_grid_x(height, width, hfov_deg)[:, None]
    rel_direction = -np.arctan(tan_xy)
    rel_x = rel_y * tan_xy
    rel_z = rel_y * _tan_grid_z(height, width, vfov_deg)[:, None]
    return (rel_x, rel_y, rel_z), rel_direction, rel_y


def single_distance_ray_grid(
    *, height: int, width: int, hfov_deg: float = 90.0, distance: float = 3.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One ray per patch at a fixed ``distance`` (numpy, static): the
    camera-frame position ``[H*W, 1, 3]``, direction ``[H*W, 1]`` and
    distance ``[H*W, 1]``; the vertical tangent at a 90-degree field."""
    tan_xy = _tan_grid_x(height, width, hfov_deg)[:, None]
    rel_direction = -np.arctan(tan_xy)
    rel_y = np.full((height * width, 1), distance, np.float32)
    rel_x = rel_y * tan_xy
    rel_z = rel_y * _tan_grid_z(height, width, 90.0)[:, None]
    return np.stack([rel_x, rel_y, rel_z], axis=-1), rel_direction, rel_y


def unproject_depth_intrinsics(depth: torch.Tensor, intrinsics: torch.Tensor,
                               rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``depth [H, W]`` (z-forward camera frame) through a pinhole K and the
    camera-to-world ``(rot, trans)`` -> world points ``[H*W, 3]``."""
    H, W = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    z = depth.to(torch.float32)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    cam = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return cam @ rot.T + trans[None, :]


def scale_intrinsics(intrinsics: torch.Tensor, from_hw: Tuple[int, int],
                     to_hw: Tuple[int, int]) -> torch.Tensor:
    """Rescale a pinhole K (``[3, 3]`` or ``[4, 4]``) between resolutions."""
    sy = to_hw[0] / from_hw[0]
    sx = to_hw[1] / from_hw[1]
    k = intrinsics.to(torch.float32).clone()
    scale = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]],
                         dtype=torch.float32, device=k.device)
    k[:3, :3] = k[:3, :3] * scale
    return k


def patch_geometry_from_pose(depth: torch.Tensor, intrinsics: torch.Tensor,
                             rot: torch.Tensor, trans: torch.Tensor, height: int,
                             width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-pose patch geometry of a posed frame: ``depth [H*W]`` and a K
    scaled to ``(height, width)`` -> ``(ppos [H*W, 3], pdir [H*W],
    pscale [H*W])``.  The direction is the heading of the WORLD point (the
    translation is part of the angle, as in the reference); the scale uses
    ``|cx / fx|`` of K."""
    ppos = unproject_depth_intrinsics(depth.reshape(height, width), intrinsics, rot, trans)
    tan_last = torch.abs(intrinsics[0, 2] / intrinsics[0, 0])
    pscale = depth.reshape(-1).to(torch.float32) * (tan_last * 2.0 / width)
    return ppos, heading_from_positions(ppos), pscale


def camera_heading_from_rotation(rot: torch.Tensor, trans: torch.Tensor):
    """Ground-plane heading of ``rot @ [0, 0, 1] + trans`` (the reference's
    T-polluted camera direction, consistent with the stored patch
    directions) and the camera origin."""
    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=rot.device)
    fwd = rot @ e_z + trans
    origin = rot @ torch.zeros(3, dtype=torch.float32, device=rot.device) + trans
    return heading_from_positions(fwd[None, :])[0], origin


def view_k(intrinsics: torch.Tensor, depth_hw: Tuple[int, int],
           view_hw: Tuple[int, int]) -> torch.Tensor:
    """Depth-resolution K -> view-resolution K: focal lengths scaled by
    view/depth size, the principal point pinned to the view center."""
    k = intrinsics.to(torch.float32)[:3, :3].clone()
    vh, vw = view_hw
    dh, dw = depth_hw
    k[0, 0] = k[0, 0] * (vw / dw)
    k[1, 1] = k[1, 1] * (vh / dh)
    k[0, 2] = vw / 2.0
    k[1, 2] = vh / 2.0
    return k


def ray_grid_intrinsics(intrinsics: torch.Tensor, *, height: int, width: int,
                        near: float = 0.0, far: float = 10.0, n_samples: int = 501):
    """Camera-frame ray grid from a view-resolution K: pixel rays
    ``((u - cx) d / fx, (v - cy) d / fy, d)`` at ``near + spacing * i`` for
    ``i = 1..n_samples``; the direction is ``-arctan(x / z)``.

    Returns ``(rel_position [H*W, NS, 3], rel_direction [H*W, 1],
    rel_dist [H*W, NS])``."""
    dev = intrinsics.device
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    spacing = (far - near) / n_samples
    dist = near + spacing * torch.arange(1, n_samples + 1, dtype=torch.float32, device=dev)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    tan_x = ((u - cx) / fx * torch.ones((height, 1), device=dev)).reshape(-1)
    tan_y = ((v - cy) / fy * torch.ones((1, width), device=dev)).reshape(-1)
    rel_x = tan_x[:, None] * dist[None, :]
    rel_y = tan_y[:, None] * dist[None, :]
    rel_z = dist[None, :].expand(rel_x.shape)
    rel_position = torch.stack([rel_x, rel_y, rel_z], dim=-1)
    return rel_position, -torch.arctan(tan_x)[:, None], rel_z
