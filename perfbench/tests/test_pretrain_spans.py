"""CPU tests of the 3DFF pretraining cell's per-layer readers
(``perfbench/pretrain_spans.py``, ``flops_fields.py`` and the metrics of
``3dff-pretrain-frames``) on a hand-built window of two traced iterations,
and on what a program without the pretraining spans hands over (each
reader gives None, and none raises)."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from dynam3d_torch.runtime import profiling  # noqa: E402
from perfbench import flops, flops_fields  # noqa: E402
from perfbench.harness import load_module  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "3dff-pretrain-frames"
METRICS = [m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [])]
Span = profiling.Span
FIELDS = SimpleNamespace(fts_dim=768, view_height=12, view_width=12, n_importance=8,
                         search_num=4)


def _read(name, d):
    mod = load_module(os.path.join(ROOT, "perfbench", "metrics", name + ".py"),
                      "m_" + name.replace(".", "_"))
    return mod.read(d)


def _window():
    out = []
    for it, t in ((7, 10.0), (8, 12.0)):
        def add(name, a, b, parent="pretrain.iter"):
            out.append(Span(name, t + a, t + b, parent, 1, it))

        add("pretrain.iter", 0.0, 1.9, None)
        add("pretrain.load", 0.00, 0.05)
        add("pretrain.build", 0.05, 0.27)
        add("pretrain.build.clip", 0.06, 0.10, "pretrain.build")
        add("pretrain.fold", 0.30, 0.80)
        add("pretrain.render", 0.85, 0.95, "pretrain.losses")
        add("pretrain.render", 0.95, 1.05, "pretrain.losses")
        add("pretrain.backward", 1.10, 1.80)
    out.append(Span("pretrain.fold", 20.0, 25.0, "pretrain.iter", 1, 9))  # not traced
    trace = {"window_s": 4.0, "busy_s": 1.5,
             "kernel_s": {"void d3::nerf_mlp_kernel<768>(CUtensorMap, Params)": 4 * 7e-5,
                          "void d3::nerf_mlp_weights_kernel(Sources, int)": 1.0}}
    return {"trace_iters": [7, 8], "program_spans": out, "trace": trace, "fields": FIELDS,
            "program_counts": {"sync": 400, "pretrain.iters": 2, "render.near_tiles": 90},
            "trace_launches": {"nerf_mlp": 4}, "flops_per_iter": [3e12, 3e12]}


def test_the_cell_names_eight_readers():
    assert sorted(METRICS) == sorted([
        "batch_build_ms.pretrain", "fold_ms.pretrain", "render_ms.pretrain",
        "backward_ms.pretrain", "syncs_per_step.pretrain", "nerf_mlp_roofline.pretrain",
        "device_idle_pct.pretrain", "step_mfu.pretrain"])


def test_readers_on_a_window():
    d = _window()
    assert _read("batch_build_ms.pretrain", d) == pytest.approx(220.0)
    assert _read("fold_ms.pretrain", d) == pytest.approx(500.0)
    assert _read("render_ms.pretrain", d) == pytest.approx(200.0)
    assert _read("backward_ms.pretrain", d) == pytest.approx(700.0)
    assert _read("syncs_per_step.pretrain", d) == pytest.approx(200.0)
    assert _read("device_idle_pct.pretrain", d) == pytest.approx(62.5)
    bound = flops_fields.nerf_mlp_bound_s(1152, 768)
    assert _read("nerf_mlp_roofline.pretrain", d) == pytest.approx(100 * 4 * bound / 2.8e-4)
    assert _read("step_mfu.pretrain", d) == pytest.approx(100 * 6e12 / 4.0 / flops.BF16_PEAK)


def test_kernel_c_counts():
    # one view of the cell: 1152 rows, its operations bound it (PERF.md's table: 0.0082 ms)
    assert flops_fields.nerf_mlp_flops(1152, 768) == 2.0 * 1152 * (6 * 768 * 768 + 768)
    assert flops_fields.nerf_mlp_bound_s(1152, 768) == pytest.approx(8.247e-6, rel=1e-3)
    assert flops_fields.render_train_flops(FIELDS) > 3 * 2 * flops_fields.nerf_mlp_flops(1152, 768)


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_the_spans_gives_none(name):
    d = _window()
    # the parent's program: its fold still counts syncs, but records no
    # pretrain span and no pretrain.iters; and no traced iteration on the CPU
    parent = dict(d, program_spans=[s for s in d["program_spans"]
                                    if not s.name.startswith("pretrain.")],
                  program_counts={"sync": 120})
    if name.startswith(("batch_build", "fold", "render", "backward", "syncs")):
        assert _read(name, parent) is None
    cpu = {"trace_iters": [], "program_spans": [], "program_counts": {}, "trace": None,
           "fields": FIELDS, "trace_launches": {}}
    assert _read(name, cpu) is None
