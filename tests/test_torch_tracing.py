"""The program's own spans and counters (``dynam3d_torch/runtime/profiling.py``)
on the CPU.

* Off (the default): ``span`` hands back one shared null context without
  reading the clock, ``count`` records nothing.
* On: parents from a thread-local stack, step indices per thread (also
  under ``EpisodeRunner.run_interleaved``), a bounded buffer, and the
  recording that a ``torch.profiler`` profile switches on by itself
  (``trace`` writes the region's spans beside its Chrome trace; this also
  pins the installed torch's profiler flag that ``recording`` reads).
* A tiny ``EpisodeRunner`` episode (the YOLOv8-seg provider, B=1 on the
  speculative route, B=5 on ``greedy_decode``) emits the named spans in
  order, a ``generate.pass`` per pass that ``step_log`` counts, and the
  same ids and ``step_log`` with recording on and off.
"""

import json
import os
import threading

import pytest
import torch

from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime import profiling
from dynam3d_torch.runtime.episode import EpisodeRunner
from dynam3d_torch.runtime.feed import SyntheticRoomFeed
from tests.torch_parity import port_config, slice_config


@pytest.fixture(autouse=True)
def _fresh():
    profiling.disable()
    profiling.reset()
    profiling.set_step(None)
    yield
    profiling.disable()
    profiling.reset()
    profiling.set_step(None)


@pytest.fixture(scope="module")
def tiny_policy():
    cfg = port_config(slice_config(provider="yolov8"))
    return cfg, tpolicy.init_policy_params(0, cfg, llm_dtype=torch.float32, device="cpu")


def _episode(cfg, params, batch=1, steps=3, record=False):
    if record:
        profiling.enable()
    try:
        runner = EpisodeRunner(params, cfg, device="cpu")
        runner.run([SyntheticRoomFeed(rgb_size=56, depth_size=32, views=1, seed=s)
                    for s in range(batch)], max_steps=steps, ignore_stop=True)
    finally:
        profiling.disable()
    return runner


def test_off_is_one_null_context_that_reads_no_clock(monkeypatch):
    calls = []
    real = profiling.time.perf_counter
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: calls.append(1) or real())
    assert not profiling.recording()
    a, b = profiling.span("step"), profiling.span("perceive.fold")
    assert a is b
    with a:
        with b:
            profiling.count("sync")
            profiling.count("decode.passes", 3)
    assert calls == []
    assert profiling.spans() == [] and profiling.counts() == {}


def test_nesting_gives_parents_and_the_step():
    profiling.enable()
    profiling.set_step(7)
    with profiling.span("step"):
        with profiling.span("perceive"):
            with profiling.span("perceive.fold"):
                profiling.count("sync")
        profiling.set_step(8)
        with profiling.span("generate"):
            profiling.count("sync", 2)
    got = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["perceive.fold", "perceive", "generate",
                                                  "step"]
    assert got["step"].parent is None and got["perceive"].parent == "step"
    assert got["perceive.fold"].parent == "perceive" and got["generate"].parent == "step"
    assert got["step"].step == 7 and got["perceive.fold"].step == 7
    assert got["generate"].step == 8
    assert got["step"].start <= got["perceive"].start <= got["perceive.fold"].start
    assert got["perceive.fold"].end <= got["perceive"].end <= got["generate"].start
    assert got["generate"].end <= got["step"].end
    assert profiling.counts() == {"sync": 3}
    profiling.reset()
    assert profiling.spans() == [] and profiling.counts() == {}


def test_threads_keep_their_own_stack_and_step():
    profiling.enable()
    gate = threading.Barrier(2, timeout=10)
    errors = []

    def worker(k):
        try:
            profiling.set_step(k)
            with profiling.span(f"outer{k}"):
                gate.wait()            # both outer spans open at once
                with profiling.span(f"inner{k}"):
                    gate.wait()
                    profiling.count("sync")
        except BaseException as e:     # re-raised by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    got = {s.name: s for s in profiling.spans()}
    for k in (1, 2):
        assert got[f"inner{k}"].parent == f"outer{k}" and got[f"outer{k}"].parent is None
        assert got[f"inner{k}"].step == got[f"outer{k}"].step == k
        assert got[f"inner{k}"].thread == got[f"outer{k}"].thread
    assert got["inner1"].thread != got["inner2"].thread
    assert profiling.counts() == {"sync": 2}


def test_the_buffer_keeps_the_newest_spans():
    profiling.enable()
    for i in range(profiling.MAX_SPANS + 10):
        with profiling.span("s"):
            profiling.set_step(i)
    sp = profiling.spans()
    assert len(sp) == profiling.MAX_SPANS
    assert sp[0].step == 9 and sp[-1].step == profiling.MAX_SPANS + 8


def test_a_profile_records_and_trace_writes_the_spans(tmp_path):
    x = torch.ones(32, 32)
    with profiling.span("before"):
        pass
    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.recording()
        with profiling.span("region"):
            with profiling.span("region.mm"):
                y = (x @ x).sum()
            profiling.count("sync")
            float(y)
    assert not profiling.recording()
    with profiling.span("after"):
        pass
    files = sorted(os.listdir(tmp_path / "tr"))
    assert len(files) == 2 and files[0].startswith("spans_") and files[1].startswith("trace_")
    assert files[0][len("spans_"):] == files[1][len("trace_"):]
    saved = json.loads((tmp_path / "tr" / files[0]).read_text())
    assert [s["name"] for s in saved["spans"]] == ["region.mm", "region"]
    assert saved["spans"][0]["parent"] == "region" and saved["counts"] == {"sync": 1}
    assert [s.name for s in profiling.spans()] == ["region.mm", "region"]


STEP_ORDER = ["step", "perceive", "perceive.depth", "perceive.clip", "perceive.segment",
              "perceive.forget", "perceive.fold", "perceive.env", "perceive.tower",
              "perceive.sync", "generate", "generate.prefill"]


def test_an_episode_emits_the_spans_in_order(tiny_policy):
    cfg, params = tiny_policy
    runner = _episode(cfg, params, record=True)
    sp = profiling.spans()
    counts = profiling.counts()
    assert len(runner.step_log) == 3
    passes = 0
    for k, entry in enumerate(runner.step_log):
        mine = sorted((s for s in sp if s.step == k), key=lambda s: s.start)
        names = [s.name for s in mine]
        assert names[: len(STEP_ORDER)] == STEP_ORDER, names
        rest = names[len(STEP_ORDER):]
        n_pass = entry["passes"]
        assert rest == ["generate.pass"] * n_pass + ["step.feed"], rest
        passes += n_pass
        by = {s.name: s for s in mine}
        assert by["perceive"].parent == by["generate"].parent == by["step.feed"].parent == "step"
        assert by["perceive.sync"].parent == by["perceive.fold"].parent == "perceive"
        assert by["generate.prefill"].parent == by["generate.pass"].parent == "generate"
        step_ms = 1e3 * (by["step"].end - by["step"].start)
        assert abs(step_ms - entry["ms"]) <= 0.01 * entry["ms"]
    assert set(counts) == {"decode.passes", "sync"}
    assert counts["decode.passes"] == passes
    # at least, a step: the segmenter's unique, the fold's sum read, unique
    # and nonzero, mm_finite, the prefill's three reads and the read-back of
    # the served ids; and the argmax read of every pass
    assert counts["sync"] >= 3 * 9 + passes


def test_greedy_decode_counts_its_passes_at_b5(tiny_policy):
    cfg, params = tiny_policy
    runner = _episode(cfg, params, batch=5, steps=2, record=True)
    sp = profiling.spans()
    n_pass = sum(1 for s in sp if s.name == "generate.pass")
    assert all(e["passes"] is None for e in runner.step_log)
    assert n_pass >= 2 and profiling.counts()["decode.passes"] == n_pass
    assert sum(1 for s in sp if s.name == "generate.prefill") == 2
    assert sum(1 for s in sp if s.name == "perceive.fold") == 10
    # the loop's stop read after the prefill and after every pass
    assert profiling.counts()["sync"] >= n_pass + 2


def test_run_interleaved_keeps_each_group_apart(tiny_policy):
    cfg, params = tiny_policy
    profiling.enable()
    try:
        runner = EpisodeRunner(params, cfg, device="cpu")
        runner.run_interleaved([SyntheticRoomFeed(rgb_size=56, depth_size=32, views=1, seed=s)
                                for s in range(4)], groups=2, max_steps=2, ignore_stop=True)
    finally:
        profiling.disable()
    sp = profiling.spans()
    steps = [s for s in sp if s.name == "step"]
    assert len(steps) == len(runner.step_log) == 4
    assert len({s.thread for s in steps}) == 2
    for s in steps:
        kids = [c for c in sp if c.thread == s.thread and c.step == s.step
                and c.parent == "step"]
        assert {c.name for c in kids} == {"perceive", "generate", "step.feed"}
        assert all(s.start <= c.start and c.end <= s.end for c in kids)
    for t in {s.thread for s in steps}:
        ks = [s.step for s in steps if s.thread == t]
        assert ks == sorted(set(ks))


def test_recording_changes_no_id_and_no_step_log_entry(tiny_policy):
    cfg, params = tiny_policy

    def log(runner):
        return [{k: v for k, v in e.items() if k != "ms"} for e in runner.step_log]

    off = _episode(cfg, params)
    assert profiling.spans() == [] and profiling.counts() == {}
    on = _episode(cfg, params, record=True)
    assert profiling.spans()
    assert log(on) == log(off)
