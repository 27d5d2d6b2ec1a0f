"""Panorama view order; ``clockwise_reorder`` of ``models/policy_3dff.py``
(the rest of that module is not ported yet)."""

from __future__ import annotations

import torch


def clockwise_reorder(x: torch.Tensor) -> torch.Tensor:
    """``[B, V, ...]`` views in the counter-clockwise sensor order ->
    clockwise: slot j takes sensor ``(V - j) % V``."""
    V = x.shape[1]
    idx = torch.tensor([(V - i) % V for i in range(V)], device=x.device)
    return x[:, idx]
