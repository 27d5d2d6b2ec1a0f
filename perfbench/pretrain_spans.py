"""What the per-layer readers of the pretraining step's spans and counters
share (``dynam3d_torch/runtime/profiling.py``; each metric keeps its own
file under ``metrics/``).

The program records while a ``torch.profiler`` profile runs in its
process: in a ``--trace 1`` run over the traced iterations and over
nothing else.  The entry hands over the spans that the program kept and
its counters, and the traced iterations' indices, which the program's
spans carry as their step (``PretrainRunner._frames_iteration`` sets it).
A program without these spans (one before them) gives None, as does a run
without traced iterations (on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def window(d) -> Optional[Tuple[List, Dict[str, int]]]:
    """The traced iterations' spans and the counters over the window, or
    None where the program recorded no ``pretrain.iter`` span."""
    if not d.get("trace_iters") or d.get("program_spans") is None:
        return None
    its = set(d["trace_iters"])
    spans = [s for s in d["program_spans"] if s.step in its]
    if not any(s.name == "pretrain.iter" for s in spans):
        return None
    return spans, d.get("program_counts") or {}


def per_iter_ms(d, name: str) -> Optional[float]:
    """The spans ``name`` summed over the traced iterations, in ms an
    iteration (None where there is none)."""
    got = window(d)
    if got is None:
        return None
    ts = [s.end - s.start for s in got[0] if s.name == name]
    return 1e3 * sum(ts) / len(d["trace_iters"]) if ts else None


def syncs_per_iter(d) -> Optional[float]:
    """The ``sync`` counter over the window, over the iterations that
    ``pretrain.iters`` counted."""
    got = window(d)
    if got is None or not got[1].get("pretrain.iters") or "sync" not in got[1]:
        return None
    return got[1]["sync"] / got[1]["pretrain.iters"]
