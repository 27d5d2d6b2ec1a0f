"""CPU tests of the per-layer readers of the program's own spans and
counters (``perfbench/program_spans.py`` and the metrics that use it), on a
hand-built window: two traced steps, the first of which lost its ``step``
and ``perceive`` spans to the window's start, as in a ``--trace 1`` run."""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from dynam3d_torch.runtime import profiling  # noqa: E402
from perfbench.harness import load_module  # noqa: E402

Span = profiling.Span


def _spans():
    """Steps 4 and 5 of a window over trace_steps [4, 5]; step 6 opened
    before the window closed; step 3 closed before it opened."""
    out = []

    def add(name, a, b, parent, step):
        out.append(Span(name, a, b, parent, 1, step))

    add("generate.pass", 0.0, 1.0, "generate", 3)
    # step 4: the window opened inside its perceive span
    add("perceive.depth", 10.000, 10.002, None, 4)
    add("perceive.fold", 10.002, 10.050, None, 4)
    add("perceive.sync", 10.050, 10.100, None, 4)
    add("generate.prefill", 10.100, 10.160, "generate", 4)
    add("generate.pass", 10.160, 10.166, "generate", 4)
    add("generate.pass", 10.166, 10.174, "generate", 4)
    add("generate", 10.099, 10.175, None, 4)
    # step 5: whole
    add("step", 11.000, 11.400, None, 5)
    add("perceive", 11.004, 11.124, "step", 5)
    add("perceive.depth", 11.005, 11.007, "perceive", 5)
    add("perceive.sync", 11.100, 11.124, "perceive", 5)
    add("generate", 11.125, 11.375, "step", 5)
    add("generate.prefill", 11.126, 11.206, "generate", 5)
    for i in range(4):
        add("generate.pass", 11.21 + 0.04 * i, 11.25 + 0.04 * i, "generate", 5)
    add("step.feed", 11.380, 11.390, "step", 5)
    # step 6 opened before the window closed
    add("step", 12.0, 12.4, None, 6)
    add("perceive.depth", 12.0, 12.01, None, 6)
    return out


@pytest.fixture
def window(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _spans)
    monkeypatch.setattr(profiling, "counts",
                        lambda: {"sync": 141, "decode.passes": 6})
    return {"trace": {"window_s": 2.0, "busy_s": 1.0}, "trace_steps": [4, 5]}


def _read(name, d):
    mod = load_module(os.path.join(ROOT, "perfbench", "metrics", name + ".py"),
                      "metric_" + name.replace(".", "_"))
    return mod.read(d)


WANT = {
    # from the first perceive.* start to perceive.sync's end: 100 and 119 ms
    "perceive_ms.eval_b1": 109.5,
    "perceive_ms.eval_b12": 109.5,
    "prefill_ms.eval_b1": 70.0,
    # six passes counted: 6, 8 and four of 40 ms
    "decode_pass_ms.eval_b1": 29.0,
    "decode_pass_ms.eval_b12": 29.0,
    # step 5 alone: 400 less perceive 120, generate 250 and step.feed 10
    "runner_host_ms.eval_b1": 20.0,
    "syncs_per_step.eval_b1": 70.5,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_built_window(name, window):
    assert _read(name, window) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_a_trace(name, window):
    assert _read(name, {"trace": None, "trace_steps": []}) is None
    assert _read(name, {"trace": {"window_s": 2.0, "busy_s": 1.0}, "trace_steps": []}) is None
    # a window whose device summary came back empty still holds the spans
    assert _read(name, {"trace": None, "trace_steps": [4, 5]}) == pytest.approx(WANT[name],
                                                                               rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_from_a_program_without_spans(name, window, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, window) is None


@pytest.mark.parametrize("name", ["decode_pass_ms.eval_b1", "decode_pass_ms.eval_b12"])
def test_decode_pass_ms_divides_by_the_counted_passes(name, window, monkeypatch):
    monkeypatch.setattr(profiling, "counts", lambda: {"sync": 141, "decode.passes": 4})
    assert _read(name, window) == pytest.approx(174.0 / 4, rel=1e-9)
    monkeypatch.setattr(profiling, "counts", lambda: {"sync": 141})
    assert _read(name, window) is None
