"""Runs one cell once: finds its files by name, checks the device, hands
the cell to its entry, then prints the checks and the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its parameters in ``perfbench/workloads/<cell>.json`` (which
names the entry, ``perfbench/entries/<entry>.py``), its configuration in
the file ``BENCHMARK.json`` gives, and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
BANNED = ("jax", "jaxlib", "flax", "dynam3d_tpu")


def boot_seconds_at_start() -> float:
    """This process's start on the boot clock (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def since_start() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - boot_seconds_at_start()


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))


class Context:
    """What an entry gets: the seed, the window, the cell and its config."""

    def __init__(self, args, bench: Dict, cell: Dict, config: Dict, device):
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.bench, self.cell, self.config = bench, cell, config
        self.device = device
        self.control = bool(getattr(args, "control", False))
        self.fault = getattr(args, "fault", None)


def _metric_applies(m: Dict, cell: str) -> bool:
    return "workloads" not in m or cell in m["workloads"]


def _fmt(v) -> str:
    return repr(float(v)) if isinstance(v, (int, float)) else str(v)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default="0", choices=("0", "1"))
    # test-only: the CPU and a configuration or cell file of the tests' own
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--config-file", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cell-file", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    got = prepare(args)
    if isinstance(got, int):
        return got
    bench, entry, cell, config, device, mod = got
    import torch
    from perfbench import flops

    card = flops.card_line() if device.type == "cuda" else {"peaks": flops.PEAKS}
    print(f"perfbench: {args.workload} seed {args.seed} card {json.dumps(card)}", file=sys.stderr)
    ctx = Context(args, bench, cell, config, device)
    res = mod.run(ctx)

    return report(args, bench, entry, device, ctx, res)


def prepare(args):
    """The cell's files, the device and the entry module (or an exit code)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"perfbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = load_json(args.cell_file or os.path.join(HERE, "workloads", args.workload + ".json"))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(args.config_file or os.path.join(ROOT, conf["file"]))

    # kernel and compiler caches at fixed paths inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few threads: no idle OpenMP pools spinning beside the
    # host's own work
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, "1")

    import torch

    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {entry['chips']} CUDA device(s); "
                  f"found {have}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mod = load_module(os.path.join(HERE, "entries", cell["entry"] + ".py"),
                      "perfbench_entry_" + cell["entry"])
    return bench, entry, cell, config, device, mod


def report(args, bench, entry, device, ctx, res) -> int:
    """Checks on standard error, then the result line; an exit code."""
    import torch

    found = banned_modules()
    if found:
        print(f"perfbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4

    metrics: Dict[str, Dict] = {}
    if not ctx.trace:
        for m in bench["end_to_end"]:
            if _metric_applies(m, args.workload):
                if m["name"] not in res["e2e"]:
                    print(f"perfbench: the entry gave no {m['name']}", file=sys.stderr)
                    return 5
                metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not _metric_applies(m, args.workload):
                continue
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(res["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    notes = res.get("notes")
    if notes:
        print(f"perfbench: notes {json.dumps(notes)}", file=sys.stderr)
    checks = res["checks"]
    correct = bool(checks) and all(c["ok"] for c in checks.values())
    device_rec = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": int(entry["chips"]),
                  "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line: Dict = {"correct": correct, "attempted": int(res["attempted"]),
                  "failed": int(res["failed"]), "metrics": metrics, "device": device_rec}
    summary = res.get("trace")
    if ctx.trace and summary:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    for n, c in checks.items():
        print(f"check {n} {_fmt(c['value'])} limit {_fmt(c['limit'])} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
