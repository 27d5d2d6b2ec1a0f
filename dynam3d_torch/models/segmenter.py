"""Geometric segmenter of the patch grid; port of
``models/segmenter.py::depth_plane_segments``."""

from __future__ import annotations

import torch


def depth_plane_segments(depth: torch.Tensor, height: int, width: int,
                         max_segments: int, rel_threshold: float = 0.08,
                         n_iters: int | None = None) -> torch.Tensor:
    """Connected components of 4-neighbours with similar depth
    (``|a - b| <= rel_threshold * max(a, b)``), by ``height + width`` rounds
    of min-label propagation; labels compacted to consecutive ids by first
    occurrence, components past ``max_segments`` collapse into the last id.

    ``depth [..., H*W]`` -> ``[..., H*W]`` int64 segment ids."""
    lead = depth.shape[:-1]
    hw = height * width
    d = depth.reshape(-1, height, width)
    n = d.shape[0]
    same_r = (d[:, :, 1:] - d[:, :, :-1]).abs() <= rel_threshold * torch.maximum(
        d[:, :, 1:], d[:, :, :-1])
    same_d = (d[:, 1:, :] - d[:, :-1, :]).abs() <= rel_threshold * torch.maximum(
        d[:, 1:, :], d[:, :-1, :])
    big = torch.full((), hw, dtype=torch.int64, device=depth.device)
    labels = torch.arange(hw, device=depth.device).view(1, height, width).repeat(n, 1, 1)
    col_pad = big.expand(n, height, 1)
    row_pad = big.expand(n, 1, width)
    for _ in range(n_iters or (height + width)):
        left = torch.cat([col_pad, torch.where(same_r, labels[:, :, :-1], big)], dim=2)
        right = torch.cat([torch.where(same_r, labels[:, :, 1:], big), col_pad], dim=2)
        up = torch.cat([row_pad, torch.where(same_d, labels[:, :-1, :], big)], dim=1)
        down = torch.cat([torch.where(same_d, labels[:, 1:, :], big), row_pad], dim=1)
        labels = torch.minimum(torch.minimum(labels, torch.minimum(left, right)),
                               torch.minimum(up, down))
    labels = labels.reshape(n, hw)
    is_root = labels == torch.arange(hw, device=depth.device)
    rank = torch.cumsum(is_root.to(torch.int64), dim=1) - 1
    seg_of_root = torch.where(is_root, rank, torch.zeros_like(rank))
    ids = torch.gather(seg_of_root, 1, labels)
    return torch.clamp(ids, max=max_segments - 1).reshape(*lead, hw)
