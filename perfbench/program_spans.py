"""What the per-layer readers of the program's own spans and counters share
(``dynam3d_torch/runtime/profiling.py``; each metric keeps its own file
under ``metrics/``).

The program records its spans and counters while a ``torch.profiler``
profile runs in its process, so in a ``--trace 1`` run it records over the
traced window (``perfbench/trace.py::Traced``) and over nothing else;
``--trace 0`` runs record nothing.  The window opens and closes inside
``perceive`` (the benchmark's wrapper starts and stops it there), so it
holds one cycle of the step per traced step, and the spans that opened
before it are missing: the first traced step has no ``step`` or
``perceive`` span.  Each span carries the index of its step in
``EpisodeRunner.step_log``, the index ``trace_steps`` lists.

A program without these spans (one before them) gives None, as does a run
without traced steps (on the CPU).  The spans do not depend on the device
trace's summary: a window whose summary came back empty still holds them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def window(d) -> Optional[Tuple[List, Dict[str, int]]]:
    """The program's spans of the traced steps and its counters over the
    window, or None."""
    if not d.get("trace_steps"):
        return None
    from dynam3d_torch.runtime import profiling

    if not hasattr(profiling, "spans"):
        return None
    steps = set(d["trace_steps"])
    return [s for s in profiling.spans() if s.step in steps], profiling.counts()


def mean_ms(d, name: str) -> Optional[float]:
    """The mean length of the traced steps' spans ``name``, in ms."""
    got = window(d)
    if got is None:
        return None
    ts = [s.end - s.start for s in got[0] if s.name == name]
    return 1e3 * sum(ts) / len(ts) if ts else None


def decode_pass_ms(d) -> Optional[float]:
    """The mean decode pass, in ms: the traced steps' ``generate.pass``
    spans summed, over the passes that ``decode.passes`` counted in the
    window."""
    got = window(d)
    if got is None or not got[1].get("decode.passes"):
        return None
    total = sum(s.end - s.start for s in got[0] if s.name == "generate.pass")
    return 1e3 * total / got[1]["decode.passes"]


def perceive_ms(d) -> Optional[float]:
    """Perception's mean time a traced step, from the start of its first
    ``perceive.*`` span to the end of ``perceive.sync`` (the read of
    ``mm_finite`` that closes the ``perceive`` span): the ``perceive`` span
    less the call into ``policy.perceive``, and read so because the first
    traced step has no ``perceive`` span."""
    got = window(d)
    if got is None:
        return None
    first: Dict[int, float] = {}
    end: Dict[int, float] = {}
    for s in got[0]:
        if s.name.startswith("perceive."):
            first[s.step] = min(first.get(s.step, s.start), s.start)
            if s.name == "perceive.sync":
                end[s.step] = s.end
    ts = [end[k] - first[k] for k in end]
    return 1e3 * sum(ts) / len(ts) if ts else None
