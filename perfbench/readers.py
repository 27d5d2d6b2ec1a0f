"""Arithmetic that several per-layer readers share (each metric keeps its
own file under ``metrics/``, which names what it reads)."""

from __future__ import annotations

from perfbench import flops


def idle_pct(d):
    """The share of the traced window in which no operation ran on the
    device (the union of the profiler's device intervals, over the window)."""
    t = d["trace"]
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def vln_step_mfu(d):
    """The whole step's model FLOPs over the traced window at the bf16 peak:
    per row of each traced step, one view's perception (the segmenter and
    both CLIP towers with the projector, counted by ``flop_counter`` over
    the plain reference; the memory fold left out) and Phi-3 over at least the
    prompt's valid tokens and the tokens served after it, once each, with
    causal attention (drafts speculation rejects are not counted)."""
    t = d["trace"]
    if not t or not t.get("window_s") or not d.get("perceive_flops_per_view"):
        return None
    p3 = d["phi3"]
    total = 0.0
    for k, rows in zip(d["trace_steps"], d["trace_rows"]):
        for n, s in zip(rows, d["steps"][k]["served"]):
            total += d["views"] * d["perceive_flops_per_view"] + flops.phi3_tokens_flops(p3, n, s)
    return 100.0 * total / t["window_s"] / flops.BF16_PEAK
