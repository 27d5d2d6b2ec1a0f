"""Observation transformers; own copy of ``utils/obs_transforms.py``.

Ports of habitat_extensions/obs_transformers.py: per-sensor center cropping
(":19-100"), per-sensor resizing (":103-180"), and cubemap->equirectangular
projection (":183-251"), as numpy functions over the feed's observation
dict (no habitat registry; providers apply them in the host feed
pipeline).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np


def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Center crop trailing HxW(xC) dims (CenterCropperPerSensor)."""
    h, w = size
    H, W = img.shape[-3], img.shape[-2]
    top = (H - h) // 2
    left = (W - w) // 2
    return img[..., top : top + h, left : left + w, :]


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize of trailing HxWxC (ResizerPerSensor)."""
    h, w = size
    H, W = img.shape[-3], img.shape[-2]
    ri = np.floor(np.arange(h) * (H / h)).astype(np.int64)
    ci = np.floor(np.arange(w) * (W / w)).astype(np.int64)
    return img[..., ri, :, :][..., ci, :]


def apply_per_sensor(
    obs: Dict[str, np.ndarray],
    crops: Dict[str, Tuple[int, int]] | None = None,
    resizes: Dict[str, Tuple[int, int]] | None = None,
) -> Dict[str, np.ndarray]:
    out = dict(obs)
    for k, size in (crops or {}).items():
        if k in out:
            out[k] = center_crop(out[k], size)
    for k, size in (resizes or {}).items():
        if k in out:
            out[k] = resize_nearest(out[k], size)
    return out


def cubemap_to_equirect(
    faces: Dict[str, np.ndarray], out_hw: Tuple[int, int]
) -> np.ndarray:
    """Project 6 cube faces (keys F,R,B,L,U,D; square HxWxC) to an
    equirectangular panorama (CubeMap2Equirect)."""
    H, W = out_hw
    face_sz = next(iter(faces.values())).shape[0]
    C = next(iter(faces.values())).shape[-1]
    lon = (np.arange(W) + 0.5) / W * 2 * math.pi - math.pi   # [-pi, pi)
    lat = math.pi / 2 - (np.arange(H) + 0.5) / H * math.pi   # [pi/2, -pi/2)
    lon, lat = np.meshgrid(lon, lat)
    x = np.cos(lat) * np.sin(lon)
    y = np.sin(lat)
    z = np.cos(lat) * np.cos(lon)

    ax = np.abs(x)
    ay = np.abs(y)
    az = np.abs(z)
    out = np.zeros((H, W, C), next(iter(faces.values())).dtype)

    def sample(face, u, v, mask):
        uu = np.clip(((u + 1) / 2 * face_sz), 0, face_sz - 1).astype(np.int64)
        vv = np.clip(((v + 1) / 2 * face_sz), 0, face_sz - 1).astype(np.int64)
        out[mask] = faces[face][vv[mask], uu[mask]]

    m = (az >= ax) & (az >= ay) & (z > 0)
    sample("F", x / np.maximum(az, 1e-9), -y / np.maximum(az, 1e-9), m)
    m = (az >= ax) & (az >= ay) & (z < 0)
    sample("B", -x / np.maximum(az, 1e-9), -y / np.maximum(az, 1e-9), m)
    m = (ax > az) & (ax >= ay) & (x > 0)
    sample("R", -z / np.maximum(ax, 1e-9), -y / np.maximum(ax, 1e-9), m)
    m = (ax > az) & (ax >= ay) & (x < 0)
    sample("L", z / np.maximum(ax, 1e-9), -y / np.maximum(ax, 1e-9), m)
    m = (ay > ax) & (ay > az) & (y > 0)
    sample("U", x / np.maximum(ay, 1e-9), z / np.maximum(ay, 1e-9), m)
    m = (ay > ax) & (ay > az) & (y < 0)
    sample("D", x / np.maximum(ay, 1e-9), -z / np.maximum(ay, 1e-9), m)
    return out
