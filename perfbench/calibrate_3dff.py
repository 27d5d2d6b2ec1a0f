"""Readings that set the 3DFF pretraining cell's limits: the program's
compared numbers on several seeds, the lower-precision control's beside
them, and the numbers each planted fault (``faults_3dff.py``) gives, all
in one process (set-up is paid per run, the interpreter and the kernel
build once).  Not part of a benchmark run.

    python3 perfbench/calibrate_3dff.py --seeds 1,2,3 --seconds 20 \\
        [--faults frames_dropped,leaf_zeroed,clip_skipped] [--no-control]

Each run prints one JSON line (``seed``, ``program``, ``correct``, and
``control`` with ``control_correct``, or ``fault``) and appends it to
``chiprun_out/perfbench/3dff-pretrain-frames-readings.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

CELL = "3dff-pretrain-frames"


def main(argv=None) -> int:
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench import check_3dff, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=2, help="seeds each fault runs on")
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--config-file", default=None)
    p.add_argument("--cell-file", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    a.workload, a.trace, a.seed, a.fault, a.control = CELL, "0", 0, None, False
    got = harness.prepare(a)
    if isinstance(got, int):
        return got
    bench, entry, cell, config, device, mod = got
    limits = cell["check"]["limits"]
    out = a.out or os.path.join(harness.ROOT, "chiprun_out", "perfbench", f"{CELL}-readings.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    seeds = [int(s) for s in a.seeds.split(",")]
    runs = [(s, None) for s in seeds]
    runs += [(s, f) for f in a.faults.split(",") if f for s in seeds[: a.fault_seeds]]
    for seed, fault in runs:
        t0 = time.perf_counter()
        a.seed, a.fault, a.control = seed, fault, not a.no_control and fault is None
        ctx = harness.Context(a, bench, cell, config, device)
        res = mod.run(ctx)
        rec = {"workload": CELL, "seed": seed, "program": res["readings"],
               "per_iteration": res["notes"]["per_iteration"],
               "correct": all(c["ok"] for c in res["checks"].values()),
               "e2e": res["e2e"], "iters": res["attempted"],
               "memory_peak_bytes": res["memory_peak_bytes"],
               "seconds": time.perf_counter() - t0}
        if fault:
            rec["fault"] = fault
        if "control" in res:
            rec["control"] = res["control"]
            rec["control_correct"] = check_3dff.correct(limits, res["control"])
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
        del res
        gc.collect()
        if device.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    found = harness.banned_modules()
    if found:
        print(f"calibrate: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
