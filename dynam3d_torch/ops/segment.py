"""Segment means and smallest-free-slot allocation over fixed tables.

Port of ``ops/segment.py``: ``segment_mean``, ``first_free_slots`` and
``free_slot_ok``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment mean of ``values [N, D]`` by ``seg_ids [N]``; returns
    ``(means [S, D], counts [S])``, empty segments zero."""
    ar = torch.arange(num_segments, device=seg_ids.device)
    onehot = (seg_ids[None, :] == ar[:, None]).to(values.dtype)      # [S, N]
    sums = onehot @ values
    counts = onehot.sum(dim=1)
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def first_free_slots(valid: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` free (``~valid``) slots, ascending; when
    fewer are free, the tail points at the last slot."""
    C = valid.shape[0]
    free_idx = torch.nonzero(~valid).flatten()[:k].to(torch.int64)
    out = torch.full((k,), C - 1, dtype=torch.int64, device=valid.device)
    out[: free_idx.numel()] = free_idx
    return out


def free_slot_ok(valid: torch.Tensor, k_needed) -> torch.Tensor:
    """True if the table has at least ``k_needed`` free slots."""
    return (~valid).sum() >= k_needed
