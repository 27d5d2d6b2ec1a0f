"""Profiling: the program's own spans and counters, ``trace`` and ``sync``.

:func:`span` and :func:`count` mark the layer boundaries of the closed-loop
step (``runtime/episode.py``, ``models/policy.py``, the decode routes of
``models/vlm/phi3.py``).  They record while recording is on: between
:func:`enable` and :func:`disable`, and while a ``torch.profiler`` profile
runs in the process, so a profiled region (the benchmark's traced window,
:func:`trace`) carries the program's spans on the host's
``time.perf_counter`` clock.  torch has no public query for a running
profile; :func:`recording` reads the flag that ``torch.autograd.profiler``
sets, and where a torch lacks it, a profile alone records nothing.  Off
(the default), :func:`span` returns one shared null context and
:func:`count` returns at once: neither reads a clock nor allocates.

A span never synchronizes the device.  One that closes at a blocking read
the program makes anyway measures real time; any other measures the host's
time to enqueue its work.  Spans go into a bounded buffer (the newest
``MAX_SPANS``), read with :func:`spans`; counters with :func:`counts`.  The
counter ``sync`` counts the step's reads of device values to the host where
the step's layers meet (the prefill's and each decode pass's reads,
``mm_finite``, the read-back of the served ids, the step's closing
``synchronize``) and inside the memory fold and the segmenter (their
``int`` reads, ``torch.unique``, ``torch.nonzero``).  Copies from pageable
host memory also wait for the stream; it leaves those out.

``trace`` records a region with ``torch.profiler`` (host and, where the
build has it, CUDA activity) and writes a Chrome trace, viewable in
ui.perfetto.dev or chrome://tracing, with the region's spans and counters
beside it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from dynam3d_torch.utils.tree import tree_leaves

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    start: float               # time.perf_counter() seconds
    end: float
    parent: Optional[str]      # the innermost span open on this thread at the start
    thread: int
    step: Optional[int]        # the runner's step index on this thread (set_step)


_on = False
_spans: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()
_local = threading.local()
_NULL = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def recording() -> bool:
    return _on or getattr(_autograd_profiler, "_is_profiler_enabled", False)


def reset() -> None:
    """Forget every span and counter."""
    _spans.clear()
    with _counts_lock:
        _counts.clear()


def spans() -> List[Span]:
    return list(_spans)


def counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def set_step(k: Optional[int]) -> None:
    """The step index this thread's spans carry from now on."""
    _local.step = k


def _stack() -> List[str]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "start", "parent", "step")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        self.step = getattr(_local, "step", None)
        st.append(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.parent, threading.get_ident(),
                           self.step))
        return False


def span(name: str):
    """A context manager that records ``name`` over its body while recording
    is on (at entry); dotted names put a child under its parent."""
    if not recording():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if not recording():
        return
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def trace(log_dir: Optional[str], activities=None) -> Iterator[torch.profiler.profile]:
    """Profile the region and write ``trace_{pid}_{ms}.json`` (Chrome
    format) and ``spans_{pid}_{ms}.json`` (the spans that opened in the
    region, and the counters' increments over it) into ``log_dir`` (none
    with ``log_dir=None``); yields the profiler, whose ``key_averages()``
    sum the region by operator and kernel.  ``activities``: what to record,
    by default every activity the build supports (``[ProfilerActivity.CUDA]``
    records the card's kernels alone, at a fraction of the host overhead)."""
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
    if activities is None:
        activities = sorted(torch.profiler.supported_activities(), key=lambda a: a.value)
    prof = torch.profiler.profile(activities=activities)
    c0 = counts()
    prof.start()
    t0 = time.perf_counter()
    try:
        yield prof
    finally:
        prof.stop()
        if log_dir is not None:
            stamp = f"{os.getpid()}_{int(time.time() * 1000)}"
            prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
            c1 = counts()
            with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
                json.dump({"clock": "time.perf_counter",
                           "spans": [s._asdict() for s in spans() if s.start >= t0],
                           "counts": {n: v - c0.get(n, 0) for n, v in c1.items()
                                      if v != c0.get(n, 0)}}, f)


def sync(tree) -> None:
    """Wait for the card that the tree's first CUDA tensor lives on; a tree
    on the CPU needs no wait."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return
