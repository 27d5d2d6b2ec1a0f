"""Iterative heatmap non-maximum suppression of the waypoint predictor;
port of ``ops/nms.py::heatmap_nms`` in plain torch ops (no kernel)."""

from __future__ import annotations

from typing import Tuple

import torch


def heatmap_nms(pred: torch.Tensor, max_predictions: int = 5,
                sigma: Tuple[float, float] = (7.0, 5.0)) -> torch.Tensor:
    """NMS over ``[B, H, W]`` heatmaps: ``max_predictions`` rounds of a
    global argmax (first index on ties) and a suppression window of
    +-``sigma[0]`` along the last axis (circular, period W) and
    +-``sigma[1]`` along the second to last, centred on ``(ix % W,
    ix / W)`` with the true division the reference uses.  Zero except at
    the picked peaks, which keep their values (negatives clamped to 0)."""
    B, H, W = pred.shape
    flat = pred.reshape(B, H * W)
    xs = torch.arange(W, dtype=torch.float32, device=pred.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=pred.device)[None, :, None]
    rows = torch.arange(B, device=pred.device)
    supp = pred
    out = torch.zeros_like(flat)
    for _ in range(max_predictions):
        ix = torch.argmax(supp.reshape(B, H * W), dim=1)
        out[rows, ix] = flat[rows, ix]
        x_mu = (ix % W).to(torch.float32)[:, None, None]
        y_mu = (ix.to(torch.float32) / W)[:, None, None]
        x_diff = xs - x_mu
        x_diff = torch.minimum(x_diff.abs(), (x_diff + W).abs())
        y_diff = ys - y_mu
        g = ((x_diff.abs() <= sigma[0]) & (y_diff.abs() <= sigma[1])).to(torch.float32)
        supp = supp * (1.0 - g)
    return torch.clamp(out.reshape(B, H, W), min=0.0)
