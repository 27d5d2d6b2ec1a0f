"""Run a function on N local ranks, each a spawned process in one process
group, and collect what each returns.

    results = run_ranks(fn, 2, args=(...,), device="cpu")

Each rank sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (torchrun's
variables), one intra-op thread on the CPU (``torch.set_num_threads(1)``;
N ranks share the host's cores), joins the group through a file in a
temporary directory (no TCP port, so runs side by side do not collide),
calls ``fn(rank, world, device, *args)`` and writes its return value with
``torch.save`` beside the rendezvous file.  On the card a rank's device is
``cuda:{rank % device_count}``: ranks share a card when there are more
ranks than cards (NCCL refuses two ranks on one card, gloo does not).

Every process is joined with a time limit: a deadlock fails with
``TimeoutError`` instead of hanging, and a rank that raises fails the whole
run with its traceback.  ``fn`` must be importable by name (a module-level
function), and ``args`` picklable.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Sequence

import torch


def _entry(fn: Callable, rank: int, world: int, rdv: str, backend: str, device: str,
           args: Sequence[Any]) -> None:
    import torch.distributed as dist

    out = os.path.join(os.path.dirname(rdv), f"rank{rank}.pt")
    try:
        if device == "cpu":
            torch.set_num_threads(1)
            dev = torch.device("cpu")
            local = rank
        else:
            local = rank % torch.cuda.device_count()
            dev = torch.device(f"cuda:{local}")
            torch.cuda.set_device(dev)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local))
        dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank,
                                world_size=world)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, device: str = "cpu",
              backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``world`` spawned ranks; the
    ranks' return values in rank order.  ``backend``: ``gloo`` on the CPU,
    and by default on the card too (``nccl`` needs a card a rank)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        procs = [ctx.Process(target=_entry, args=(fn, r, world, rdv, backend, device,
                                                  tuple(args)), daemon=False)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # a rank that fails leaves the others blocked in a collective:
            # stop waiting as soon as one exits non-zero
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                wait([p.sentinel for p in procs if p.is_alive()], timeout=0.5)
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung and not any(p.exitcode not in (None, 0) for p in procs):
                raise TimeoutError(f"ranks {hung} of {world} did not finish in {timeout:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        recs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False)
                if os.path.exists(os.path.join(tmp, f"rank{r}.pt")) else None
                for r in range(world)]
    for r, rec in enumerate(recs):
        if rec is not None and not rec["ok"]:
            raise RuntimeError(f"rank {r} of {world} failed:\n{rec['error']}")
    bad = [(r, p.exitcode) for r, (rec, p) in enumerate(zip(recs, procs))
           if rec is None or p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks (rank, exit code) {bad} of {world} wrote no result")
    return [rec["result"] for rec in recs]
