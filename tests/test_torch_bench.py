"""``dynam3d_torch.tools.bench`` against the repo-root ``bench.py`` (loaded
by path), on the CPU:

* ``_config("tiny")`` / ``_config("full")`` equal the JAX bench's, field
  for field; ``_llm_flops_bytes`` of the bf16, int8 and int4 trees
  converted from one JAX tree equals the JAX function's;
* each of the six modes at its smallest size (``--scale tiny``, 1-2
  steps) prints exactly one JSON line last, with the JAX mode's metric
  name and the JAX mode's ``extra`` keys (read off ``bench.py`` below)
  plus ``card``;
* the bench raises without a card unless asked for the CPU; an expired
  budget prints the error line and exits 1; a failing breakdown fails the
  run; the headline attaches only this tool's own sweep file;
* the session scripts under ``dynam3d_torch/scripts/`` pass ``bash -n``,
  write only ``runs/torch_bench_round*.jsonl`` and name modules that
  import.
"""

import dataclasses
import importlib
import importlib.util
import json
import re
import subprocess
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from dynam3d_torch.tools import bench as tbench
from tests.torch_parity import to_torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("round3_card_runs.sh", "round4_card_runs.sh", "bench_round4.sh", "bench_round5.sh")


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX modes' ``extra`` keys, as bench.py writes them
RENDER_KEYS = {"baseline", "views_per_sec", "compile_s", "pallas", "banded_knn", "morton_knn",
               "patches", "patch_layout", "backend"}
WAYPOINT_KEYS = {"baseline", "compile_s", "depth_size", "candidates", "backend"}
TRAIN_KEYS = {"baseline", "compile_s", "scale", "batch", "llm_layers", "prompt_tokens",
              "train_mfu_pct", "steps_per_sec", "env_steps_per_sec", "loss", "grad_norm",
              "backend"}
PRETRAIN_KEYS = {"baseline", "compile_s", "scale", "frames", "build_batch_ms", "grad_step_ms",
                 "grad_step_mfu_pct", "grad_step_hbm_pct", "grad_step_tflops", "iters_per_sec",
                 "pipelined", "loss", "backend"}
SERVE_KEYS = {"baseline", "batch", "groups", "batched_step_ms", "interleaved_steps_per_sec",
              "single_steps_per_sec", "sync_upload_steps_per_sec", "scale", "quant_bits",
              "max_steps"}
MAIN_KEYS = {"baseline", "vs_baseline_range", "p10_ms", "p90_ms", "tunnel_rtt_p50_ms",
             "device_step_ms", "vs_baseline_device", "rgbd_to_3d_tokens_fps", "perceive_p50_ms",
             "sync_step_ms", "upload_ms", "overlap", "compile_s", "scale", "llm_layers",
             "backend", "steps", "batch", "quant_bits", "segmenter"}
BREAKDOWN_KEYS = {"rtt_ms", "perceive_ms", "prefill_ms", "decode_ms", "decode_ms_per_tok",
                  "decode_tokens", "prompt_tokens", "llm_params_m", "prefill_matmul_dtype",
                  "prefill_mfu_pct", "decode_mode"}
SPEC_KEYS = {"spec_tokens", "spec_passes", "spec_tokens_per_pass",
             "spec_tokens_per_pass_unprimed", "spec_tokens_per_pass_loop"}


def _run(capsys, argv):
    rec = tbench.main(argv + ["--scale", "tiny", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(rec))
    assert sum(1 for ln in lines if ln.startswith("{")) == 1, lines
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert last["extra"]["card"] == "cpu" and last["value"] > 0
    return last


@pytest.mark.parametrize("scale", ["tiny", "full"])
def test_config_equals_the_jax_bench(jbench, scale, monkeypatch):
    assert dataclasses.asdict(tbench._config(scale)) == dataclasses.asdict(jbench._config(scale))
    monkeypatch.setenv("DYNAM3D_BENCH_LLM_LAYERS", "4")
    monkeypatch.setenv("DYNAM3D_PREFILL_BUCKET", "64")
    assert dataclasses.asdict(tbench._config(scale)) == dataclasses.asdict(jbench._config(scale))


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_llm_flops_bytes_equals_the_jax_function(jbench, bits):
    from dynam3d_tpu.models.vlm import phi3 as jphi3

    pcfg = jbench._config("tiny").llava.phi3
    jp = jphi3.init_phi3_params(jax.random.PRNGKey(3), pcfg, dtype=jnp.bfloat16)
    if bits:
        jp = jphi3.quantize_phi3(jp, bits=bits)
    want = jbench._llm_flops_bytes(jp, None)
    assert tbench._llm_flops_bytes(to_torch(jp), None) == want
    assert want[0] > 0 and want[1] > 0


@pytest.mark.parametrize("mode,metric,keys", [
    ("render", "render_view_p50_ms", RENDER_KEYS),
    ("waypoint", "waypoint_12view_p50_ms", WAYPOINT_KEYS),
    ("train", "train_step_p50_ms", TRAIN_KEYS),
    ("pretrain", "pretrain_iter_p50_ms", PRETRAIN_KEYS),
    ("serve", "serve_steps_per_sec", SERVE_KEYS),
])
def test_mode_line(capsys, monkeypatch, mode, metric, keys):
    monkeypatch.setenv("DYNAM3D_BENCH_FRAMES", "2")
    last = _run(capsys, ["--mode", mode, "--steps", "1"])
    assert last["metric"] == metric
    assert set(last["extra"]) == keys | {"card"}
    assert last["extra"].get("backend", "cpu") == "cpu"


def _sweep_row(mode, metric, value, mfu=None):
    return json.dumps({"mode": mode, "line": {"metric": metric, "value": value,
                                              "extra": {"train_mfu_pct": mfu}}})


def test_headline_attaches_only_the_torch_sweep(capsys, monkeypatch, tmp_path):
    (tmp_path / "runs").mkdir()
    (tmp_path / "runs" / "bench_round5.jsonl").write_text(
        _sweep_row("train", "train_step_p50_ms", 111.0, 1.0) + "\n"
        + _sweep_row("waypoint", "waypoint_12view_p50_ms", 222.0) + "\n")
    (tmp_path / "runs" / "torch_bench_round5.jsonl").write_text(
        _sweep_row("train", "train_step_p50_ms", 7.5, 2.5) + "\nnot json\n"
        + json.dumps({"mode": "pretrain", "error": True}) + "\n")
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))
    last = _run(capsys, ["--steps", "2"])
    ex = last["extra"]
    assert last["metric"] == "p50_step_latency_ms" and last["vs_baseline"] is None
    assert set(ex) == MAIN_KEYS | BREAKDOWN_KEYS | SPEC_KEYS | {
        "train_step_p50_ms", "train_mfu_pct", "card"}
    assert ex["train_step_p50_ms"] == 7.5 and ex["train_mfu_pct"] == 2.5
    assert ex["decode_mode"] == "spec" and ex["prefill_mfu_pct"] is None
    assert ex["baseline"] == "not-comparable (reduced config)"


def test_headline_greedy_breakdown(capsys, monkeypatch, tmp_path):
    """Plain greedy decode reports the decode's memory-rate share (null on
    the CPU) in place of the speculation stats; no sweep file, none attached."""
    monkeypatch.setenv("DYNAM3D_SPEC_DECODE", "0")
    monkeypatch.setattr(tbench, "ROOT", str(tmp_path))
    ex = _run(capsys, ["--steps", "1"])["extra"]
    assert set(ex) == MAIN_KEYS | BREAKDOWN_KEYS | {"decode_hbm_pct", "card"}
    assert ex["decode_mode"] == "greedy" and ex["decode_hbm_pct"] is None


def test_failing_breakdown_fails_the_run(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("breakdown broke")

    monkeypatch.setattr(tbench, "_phase_breakdown", broken)
    with pytest.raises(RuntimeError, match="breakdown broke"):
        tbench.main(["--steps", "1", "--scale", "tiny", "--device", "cpu"])
    assert not any(ln.startswith("{") for ln in capsys.readouterr().out.splitlines())


def test_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no.*available|none is available"):
        tbench.main(["--mode", "waypoint", "--scale", "tiny", "--steps", "1"])


def test_expired_budget_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setenv("DYNAM3D_BENCH_BUDGET_S", "1")
    monkeypatch.setattr(tbench, "main", lambda argv=None: time.sleep(10))
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        tbench._watchdog_main([])
    assert e.value.code == 1 and time.perf_counter() - t0 < 5
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == -1.0 and line["extra"]["error"] == "device stalled; aborted after 1s"


@pytest.mark.parametrize("name", SCRIPTS)
def test_session_script(name):
    path = ROOT / "dynam3d_torch" / "scripts" / name
    subprocess.run(["bash", "-n", str(path)], check=True)
    text = path.read_text()
    mods = set(re.findall(r"-m (dynam3d_torch\.[\w.]+)", text))
    assert "dynam3d_torch.tools.bench" in mods or name.startswith("round")
    for m in mods:
        importlib.import_module(m)
    assert "bench.py" not in text and "jax" not in text.lower()
    writes = set(re.findall(r"runs/[\w./]+", text))
    assert writes <= {"runs/torch_bench_round4.jsonl", "runs/torch_bench_round5.jsonl"}, writes
    assert "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader" in text
