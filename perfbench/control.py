"""Readings that set a cell's limits: the program's compared numbers on
many seeds, the lower-precision control's beside them, and the numbers
each planted fault gives, all in one process (set-up is paid per seed, the
interpreter and the kernel build once).  Not part of a benchmark run.

    python3 perfbench/control.py --workload vln-eval-b1 --seeds 1,2,3 \\
        --seconds 10 [--sample-range 24] [--faults token_altered,...] [--no-control]

Each seed prints one JSON line (``seed``, ``program``, and ``control`` or
``fault``) and appends it to ``chiprun_out/perfbench/<cell>-readings.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--sample-range", type=int, default=None)
    p.add_argument("--faults", default="")
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--config-file", default=None)
    p.add_argument("--cell-file", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    a.trace, a.seed, a.fault, a.control = "0", 0, None, False
    got = harness.prepare(a)
    if isinstance(got, int):
        return got
    bench, entry, cell, config, device, mod = got
    if a.sample_range is not None:
        cell["check"]["sample_range"] = a.sample_range
    out = a.out or os.path.join(harness.ROOT, "chiprun_out", "perfbench",
                                f"{a.workload}-readings.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    runs = [(int(s), None) for s in a.seeds.split(",")]
    runs += [(int(s), f) for f in a.faults.split(",") if f for s in a.seeds.split(",")[:3]]
    for seed, fault in runs:
        t0 = time.perf_counter()
        a.seed, a.fault, a.control = seed, fault, not a.no_control and fault is None
        ctx = harness.Context(a, bench, cell, config, device)
        res = mod.run(ctx)
        rec = {"workload": a.workload, "seed": seed,
               "program": res.get("readings") or {n: c["value"] for n, c in res["checks"].items()},
               "correct": all(c["ok"] for c in res["checks"].values()),
               "e2e": res["e2e"], "seconds": time.perf_counter() - t0}
        if fault:
            rec["fault"] = fault
        if "control" in res:
            from perfbench import check_vln

            judged = check_vln.judge(cell["check"]["limits"], res["control"])
            rec["control"] = res["control"]
            rec["control_correct"] = all(c["ok"] for c in judged.values())
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
        print(f"control: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
