"""Masked brute-force k-nearest neighbours over fixed-capacity tables.

Port of ``ops/knn.py::knn_brute`` and ``radius_mask_fill``: squared
distances by the ``|q|^2 + |p|^2 - 2 q.p`` expansion in full float32, dead
slots at distance 1e10, ties to the smallest id; ``radius_mask_fill``
marks neighbours beyond a radius with index -1.
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e10


def pairwise_sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    q2 = (queries * queries).sum(dim=-1, keepdim=True)
    p2 = (points * points).sum(dim=-1, keepdim=True).T
    cross = queries @ points.T          # full fp32: TF32 is pinned off on the card
    return torch.clamp(q2 + p2 - 2.0 * cross, min=0.0)


def knn_brute(queries: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sq_dists [Q, k], indices [Q, k])`` ascending; ties keep the
    smaller index (a stable sort), dead slots surface as >= 1e10."""
    d = pairwise_sq_dists(queries.to(torch.float32), points.to(torch.float32))
    d = torch.where(valid[None, :], d, torch.full_like(d, BIG))
    dist, idx = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


def radius_mask_fill(sq_dists: torch.Tensor, indices: torch.Tensor, radius: float,
                     clamp_dist: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean distances, with index -1 at or beyond ``radius`` (and the
    distance clamped to ``radius`` there when ``clamp_dist``)."""
    d = torch.sqrt(sq_dists)
    out_of_range = d >= radius
    idx = torch.where(out_of_range, torch.full_like(indices, -1), indices)
    if clamp_dist:
        d = torch.where(out_of_range, torch.full_like(d, radius), d)
    return d, idx
