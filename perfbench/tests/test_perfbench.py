"""CPU tests of the benchmark harness (run them with
``python -m pytest perfbench/tests -q -p no:cacheprovider``).

Each cell runs here against a test-only tiny configuration and cell file
(``tiny-*.json`` beside this file), through the same harness, entry and
check as on the card.  The tests that need the card decide so inside the
test and skip here.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY_CONFIG = {"dynam3d-vln-phi3-mini": "tiny-vln.json"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _tiny_args(cell: str):
    cfg = next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    return ["--device", "cpu", "--config-file", os.path.join(HERE, TINY_CONFIG[cfg]),
            "--cell-file", os.path.join(HERE, f"tiny-{cell}.json")]


def _run(script: str, args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", script), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert m.get("workloads", CELLS) and set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:      # each cell that reports it reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    w = json.load(open(os.path.join(ROOT, "perfbench", "workloads", cell + ".json")))
    assert os.path.exists(os.path.join(ROOT, "perfbench", "entries", w["entry"] + ".py"))
    conf = next(c for c in BENCH["configs"]
                if c["name"] == next(x["config"] for x in BENCH["workloads"] if x["name"] == cell))
    assert conf["file"].startswith("perfbench/")
    assert os.path.exists(os.path.join(ROOT, conf["file"]))
    sys.path.insert(0, ROOT)
    from perfbench.harness import load_module

    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", CELLS):
            mod = load_module(os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py"),
                              "metric_" + m["name"].replace(".", "_"))
            assert callable(mod.read)


@pytest.mark.parametrize("trace", ["0", "1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_the_result_line(cell, trace):
    r = _run("run.py", ["--workload", cell, "--seed", str(2 ** 33 + 7), "--seconds", "2",
                        "--trace", trace, *_tiny_args(cell)])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
    if trace == "0":
        want = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}
        assert set(line["metrics"]) == want
    else:
        allowed = {m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)}
        assert set(line["metrics"]) <= allowed     # device readers read nothing on the CPU


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_and_the_control_fails(cell, tmp_path):
    out = tmp_path / "r.jsonl"
    r = _run("control.py", ["--workload", cell, "--seeds", "41", "--seconds", "2",
                            "--out", str(out), *_tiny_args(cell)])
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["correct"], rec
    assert rec["control_correct"] is False, rec


FAULTS = {"vln-eval-b1": ["state_unchanged", "token_altered"],
          "vln-eval-b12": ["state_unchanged", "half_batch", "token_altered"]}


@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_make_correct_false(cell, tmp_path):
    out = tmp_path / "f.jsonl"
    r = _run("control.py", ["--workload", cell, "--seeds", "43", "--seconds", "2", "--no-control",
                            "--faults", ",".join(FAULTS[cell]), "--out", str(out),
                            *_tiny_args(cell)])
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert recs[0]["correct"]
    assert {x["fault"] for x in recs[1:]} == set(FAULTS[cell])
    assert not any(x["correct"] for x in recs[1:]), recs


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, pkgutil, importlib, perfbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'perfbench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = {n.split('.')[0] for n in sys.modules} & "
            "{'dynam3d_torch', 'dynam3d_tpu', 'jax', 'jaxlib', 'flax'}\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_run_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    if _has_cuda():
        pytest.skip("a CUDA device is present")
    r = _run("run.py", ["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert r.returncode != 0 and not r.stdout.strip()
    # a directory with only BENCHMARK.json and perfbench/: the program is missing
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench")
    r = subprocess.run([sys.executable, "perfbench/run.py", *(
        ["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]
        + _tiny_args(CELLS[0])[:2])], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()


def _has_cuda() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not _has_cuda():
        pytest.skip("needs a CUDA device")
    r = _run("run.py", ["--workload", cell, "--seed", str(2 ** 33 + 11), "--seconds", "8",
                        "--trace", "0"], timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
