"""Faults planted under the timed path of the 3DFF pretraining cell, for
the tests and readings that show its check catches them (never in a
benchmark run): half of each scene's frames dropped before the program
sees them, one trainable leaf's gradient zeroed before the optimizer, and
the per-value gradient clip skipped."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

ZEROED = "render/agg_w"        # the leaf whose gradient ``leaf_zeroed`` zeroes


def scene(fault: Optional[str], sc: Dict) -> Dict:
    """The scene the program gets: with ``frames_dropped``, every other
    frame (the check keeps the whole scene)."""
    if fault != "frames_dropped":
        return sc
    out = dict(sc)
    for k in ("rgb", "depth", "position", "heading"):
        out[k] = sc[k][::2]
    return out


def install(fault: Optional[str], runner) -> None:
    """``leaf_zeroed`` and ``clip_skipped`` on the runner's optimizer."""
    if fault == "clip_skipped":
        runner.opt.clip = math.inf
    elif fault == "leaf_zeroed":
        from perfbench.reference.fields_ref import leaves

        opt, update = runner.opt, runner.opt.update

        def zeroed(grads, state, params):
            names = [n for n, _ in leaves(params)]
            grads = [torch.zeros_like(g) if n == ZEROED else g for n, g in zip(names, grads)]
            return update(grads, state, params)

        opt.update = zeroed
