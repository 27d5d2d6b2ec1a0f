"""Depth preprocessing; port of
``models/encoders/depth_resnet.py::preprocess_depth`` (the ResNet depth
encoder itself is on the waypoint path and not ported)."""

from __future__ import annotations

from typing import Tuple

import torch


def preprocess_depth(depth: torch.Tensor,
                     depth_scale: Tuple[float, float] = (0.0, 10.0)) -> torch.Tensor:
    """``[B, H, W, 1]`` normalized depth -> metric depth; zero (invalid)
    pixels take the maximum of their column first."""
    lo, hi = depth_scale
    cmax = depth.amax(dim=1, keepdim=True)
    d = torch.where(depth == 0, cmax.expand_as(depth), depth)
    return lo + d * (hi - lo)
