"""The traced sub-window: ``torch.profiler`` over a few steady steps, read
into busy time, idle gaps and device time by kernel.

Only the device is traced (CUPTI's record of each kernel, copy and set):
recording every host-side operation as well would slow the host several
fold and inflate the idle share it measures.  The window is bracketed on
the device by two marker kernels (``torch.cuda._sleep``), each launched
right after a synchronize, so the device was idle and the marker starts as
the host reaches it; the host's clock at the first marker ties the
benchmark's own spans (:func:`span`, kept in memory on the host clock) to
the device's clock.  Busy time is the union of every other device
operation's interval between the markers; an idle gap is a hole in that
union and is named by the innermost span open at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

_spans: List[Tuple[float, float, str]] = []
MAX_SPANS = 1 << 16
MARKER = "spin_kernel"


@contextlib.contextmanager
def span(name: str):
    """A named span of the benchmark's own, kept in memory (the newest
    ``MAX_SPANS``) in traced and untraced runs alike."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _spans.append((t0, time.perf_counter(), name))
        if len(_spans) > MAX_SPANS:
            del _spans[: MAX_SPANS // 2]


class Traced:
    """Profiles the device from ``__enter__`` to ``__exit__``; read the
    result with :meth:`summarize` once the window has closed."""

    def __init__(self):
        self.prof = None
        self.t0 = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return False

    def summarize(self) -> Optional[Dict]:
        """After the window: the spans that closed since cover the gaps of
        those that were still open when the trace stopped."""
        out = summarize(self.prof, list(_spans), self.t0)
        self.prof = None
        return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(prof, spans: List[Tuple[float, float, str]], host_t0: float) -> Optional[Dict]:
    """``window_s``, ``busy_s``, ``kernel_s`` (device seconds by op name),
    ``device_ops`` and ``idle_gaps`` (the ten largest, as ``[name, s]``),
    or None where the trace holds no device operation."""
    dev_iv: List[Tuple[float, float, str]] = []
    markers: List[Tuple[float, float]] = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = e.time_range
        if MARKER in e.name:
            markers.append((tr.start, tr.end))
        elif tr.end > tr.start:
            dev_iv.append((tr.start, tr.end, e.name))
    if len(markers) < 2 or not dev_iv:
        return None
    markers.sort()
    w0, w1 = markers[0][1], markers[-1][0]
    kernel_us: Dict[str, float] = {}
    inside = []
    for a, b, n in dev_iv:
        if b > w0 and a < w1:
            a, b = max(a, w0), min(b, w1)
            inside.append((a, b))
            kernel_us[n] = kernel_us.get(n, 0.0) + (b - a)
    busy = _union(inside)
    holes, at = [], w0
    for a, b in busy:
        if a > at:
            holes.append((at, a))
        at = max(at, b)
    if at < w1:
        holes.append((at, w1))
    dev0 = markers[0][0]      # the device's clock (us) when the host was at host_t0

    def name_at(t_us: float) -> str:
        t = host_t0 + (t_us - dev0) / 1e6
        best = None
        for a, b, n in spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return best[2] if best else "outside_spans"

    longest = sorted(holes, key=lambda h: h[0] - h[1])[:10]
    ops = sorted(kernel_us.items(), key=lambda x: -x[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": {n: t / 1e6 for n, t in kernel_us.items()},
            "device_ops": [[n[:120], t / 1e6] for n, t in ops],
            "idle_gaps": [[name_at((a + b) / 2), (b - a) / 1e6] for a, b in longest]}


def span_seconds(t0: float, t1: float) -> Dict[str, float]:
    """Host seconds by span name of the spans that closed in ``[t0, t1]``
    (nested spans each count their own whole length)."""
    out: Dict[str, float] = {}
    for a, b, n in _spans:
        if a >= t0 and b <= t1:
            out[n] = out.get(n, 0.0) + (b - a)
    return out


def kernel_seconds(summary: Dict, *needles: str) -> float:
    """Device seconds of the ops whose name holds any of ``needles``."""
    return sum(t for n, t in summary.get("kernel_s", {}).items()
               if any(s in n for s in needles))
