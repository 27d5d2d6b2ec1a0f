"""What the port's profiling and A/B tools share: the card's name line,
timing, the decode-route gates, the int4 Phi-3-mini weights and prompts
they measure, and the near-tie test of two routes' ids.

Timing on the card follows ``decompose_int4_mma``: :func:`kernel_ms` is
its ``_time_ms`` (CUDA events over calls that each follow an L2 read flush,
the flushes subtracted); :func:`step_ms` times whole synchronized calls on
the host clock (p50), for a decode chain or a step whose host work is part
of what is measured.  A tool on the CPU runs each call once and reports
no time: its numbers are ``None`` there ("not measured").
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from dynam3d_torch.device import mem_rate
from dynam3d_torch.tools.decompose_int4_mma import _time_ms, read_flush

# dense peaks of the H100 SXM data sheet (the card's memory rate is
# ``device.mem_rate`` of its name)
INT8_PEAK = 1979e12
BF16_PEAK = 989e12
FP32_PEAK = 67e12


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0].strip()


def emit(rec: Dict, card: str) -> Dict:
    """Print ``rec`` as one JSON line beside the card it was measured on."""
    rec = {**rec, "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_ms(fn: Callable, dev: torch.device, flush=None, iters: int = 20) -> Optional[float]:
    """Mean device ms of one ``fn()`` after an L2 flush (on the CPU ``fn``
    runs once, untimed: None)."""
    if dev.type != "cuda":
        fn()
        return None
    return _time_ms(fn, flush or read_flush(), iters)


def step_ms(fn: Callable, dev: torch.device, reps: int = 3) -> Optional[float]:
    """p50 host ms of ``fn()`` between synchronizations, after one warm
    call (on the CPU ``fn`` runs once, untimed: None)."""
    fn()
    if dev.type != "cuda":
        return None
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def slope(t_hi: Optional[float], t_lo: Optional[float], n_hi: int, n_lo: int):
    """Per-unit cost between two chain lengths (None if either is None)."""
    if t_hi is None or t_lo is None:
        return None
    return (t_hi - t_lo) / (n_hi - n_lo)


def bytes_bound_ms(nbytes: float, dev: torch.device) -> Optional[float]:
    """Least ms to move ``nbytes`` at the card's data-sheet memory rate."""
    if dev.type != "cuda":
        return None
    return nbytes / mem_rate(torch.cuda.get_device_name(dev)) * 1e3


@contextlib.contextmanager
def env(**gates: str) -> Iterator[None]:
    """Set the route gates (``DYNAM3D_*`` environment variables, read at
    call time) for the block, then restore them."""
    old = {k: os.environ.get(k) for k in gates}
    os.environ.update(gates)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


ROUTES = {
    # route name -> the gates that select it
    "ring": {"DYNAM3D_FUSED_ATTN": "1", "DYNAM3D_FUSED_RING": "1"},
    "split": {"DYNAM3D_FUSED_ATTN": "1", "DYNAM3D_FUSED_RING": "0"},
    "unfused": {"DYNAM3D_FUSED_ATTN": "0"},
}


def int4_phi3(seed: int, dev: torch.device, cfg=None):
    """``(cfg, params)``: Phi-3 (the default Phi-3-mini) from a
    ``torch.Generator`` of ``seed``, packed to int4 (``quantize_phi3(bits=4)``)."""
    from dynam3d_torch.config import Phi3Config
    from dynam3d_torch.models.vlm import phi3

    cfg = cfg or Phi3Config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = phi3.quantize_phi3(phi3.init_phi3_params(gen, cfg, device=dev), bits=4,
                                consume=True)
    return cfg, params


def prompt(cfg, dev: torch.device, rows: int, T: int, seed: int = 0, holes=None):
    """``(embeds [rows, T, D] bf16, valid [rows, T])``: normal embeddings
    (scale 0.5) from numpy ``seed``; ``holes[b]`` is a masked span of row
    b."""
    rng = np.random.default_rng(seed)
    e = torch.as_tensor(rng.normal(scale=0.5, size=(rows, T, cfg.hidden_size)),
                        dtype=torch.float32).to(dev, torch.bfloat16)
    valid = np.ones((rows, T), bool)
    for b, (lo, hi) in enumerate(holes or []):
        valid[b, lo:hi] = False
    return e, torch.as_tensor(valid, device=dev)


@contextlib.contextmanager
def margins() -> Iterator[list]:
    """Record the logits of every ``phi3._lm_head`` call in the block, and of
    every B=1 ring pass (``phi3._ring_pass``, whose head a replayed CUDA
    graph runs without calling it): for each, the top-2 margin and the
    scale (max |logit|) of every row and position (``[B, T]`` lists) and
    the last position's logits ``[B, V]`` on the host, for telling a
    near-tie from a fault where two routes' greedy ids differ."""
    from dynam3d_torch.models.vlm import phi3

    seen, head, ring = [], phi3._lm_head, phi3._ring_pass

    def record(lg):
        f = lg.float()
        top2 = f.topk(2, dim=-1).values
        seen.append({"margin": (top2[..., 0] - top2[..., 1]).tolist(),
                     "scale": f.abs().amax(-1).tolist(), "logits": f[:, -1].cpu()})
        return lg

    def recording(params, x, tp=None):
        return record(head(params, x, tp))

    def ring_recording(*args):
        phi3._lm_head = head            # the pass may be captured: no reads inside
        try:
            out = ring(*args)
        finally:
            phi3._lm_head = recording
        record(out[0])
        return out

    phi3._lm_head, phi3._ring_pass = recording, ring_recording
    try:
        yield seen
    finally:
        phi3._lm_head, phi3._ring_pass = head, ring


def first_difference(got, want):
    """Index of the first differing id of two id lists, or None."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def ids_agree(got, want, passes, row: int, rel: float, at=None) -> Dict:
    """Whether row ``row``'s ids ``got`` equal ``want``, where a difference
    counts as a near-tie (allowed) when the logits that chose the first
    differing id had a top-2 margin under ``rel`` x their scale.
    ``passes``: :func:`margins` of the run whose logits chose the ids;
    ``at(i) -> (call, position)`` locates id i there (default: call i, the
    last position: a prefill, then one decode pass a token)."""
    i = first_difference(got, want)
    if i is None:
        return {"equal": True, "first_difference": None, "ok": True}
    call, pos = at(i) if at else (i, -1)
    m, s = passes[call]["margin"][row][pos], passes[call]["scale"][row][pos]
    return {"equal": False, "first_difference": i, "margin": m, "scale": s,
            "ok": m < rel * s}
