"""CPU runs of the ``3dff-pretrain-frames`` cell through the harness at a
test-only tiny configuration and cell file (``tiny-fields.json``,
``tiny-3dff-pretrain-frames.json`` beside this file): the result line of
both kinds of run, and the check's readings of the program, of the
lower-precision control and of the planted faults
(``perfbench/faults_3dff.py``), through ``calibrate_3dff.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "3dff-pretrain-frames"
TINY = ["--device", "cpu", "--config-file", os.path.join(HERE, "tiny-fields.json"),
        "--cell-file", os.path.join(HERE, f"tiny-{CELL}.json")]


def _run(script, args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", script), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_the_cell_prints_the_result_line(trace):
    r = _run("run.py", ["--workload", CELL, "--seed", str(2 ** 33 + 7), "--seconds", "2",
                        "--trace", trace, *TINY])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    if trace == "0":
        assert set(line["metrics"]) == {"step_ms", "setup_s"}
    else:
        allowed = {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [])}
        assert set(line["metrics"]) <= allowed     # device readers read nothing on the CPU


def test_the_control_and_the_faults_read_not_correct(tmp_path):
    out = tmp_path / "r.jsonl"
    r = _run("calibrate_3dff.py", ["--seeds", "41", "--seconds", "2", "--faults",
                                   "frames_dropped,leaf_zeroed", "--fault-seeds", "1",
                                   "--out", str(out), *TINY])
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert recs[0]["correct"] and recs[0]["control_correct"] is False, recs[0]
    assert [x["fault"] for x in recs[1:]] == ["frames_dropped", "leaf_zeroed"]
    assert not any(x["correct"] for x in recs[1:]), recs
