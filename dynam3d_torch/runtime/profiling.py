"""Profiling helpers; port of ``runtime/profiling.py`` (``trace``, ``sync``,
``StepTimer``).

``trace`` records a region with ``torch.profiler`` (host and, where the
build has it, CUDA activity) and writes a Chrome trace, viewable in
ui.perfetto.dev or chrome://tracing; ``StepTimer`` keeps host-clock step
times and their percentiles.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from dynam3d_torch.utils.tree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the region and write ``trace_{pid}_{ms}.json`` (Chrome
    format) into ``log_dir``; yields the profiler, whose
    ``key_averages()`` sum the region by operator and kernel."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=sorted(torch.profiler.supported_activities(),
                                                    key=lambda a: a.value))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


def sync(tree) -> None:
    """Wait for the card that the tree's first CUDA tensor lives on; a tree
    on the CPU needs no wait."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class StepTimer:
    """Percentile step timer (host clock); persists a jsonl summary.  Time
    only regions that end in :func:`sync` or another read of the device."""

    def __init__(self, name: str = "step"):
        self.name = name
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples) * 1000.0
        return {
            "name": self.name,
            "n": len(arr),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
            "mean_ms": float(arr.mean()),
        }

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.stats()) + "\n")
