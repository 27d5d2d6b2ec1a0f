"""Sweep the ring depth S and tile width nblk of the streamed int4 matvec
(kernel I, ``ops/int4_stream.py``) on the card.

    python -m dynam3d_torch.tools.bench_int4_stream

Port of ``tools/bench_int4_stream.py``.  NW = 4 distinct packed weights at
the Phi-3 gate_up shape (3072 x 16384) stream per chain step, and each step
feeds its output back as the next input, so no weight is reused from cache
between steps.  The time per matvec is the slope between chains of 32 and
160 steps (medians of 7 repeats), which cancels the fixed cost of a chain;
the chain's own small ops per step stay in it.  Each chain is captured as a
CUDA graph (the counterpart of the TPU tool's jitted chain: the host
launches it once) and its replays are timed by CUDA events.

Kernel I runs on the tensor-core body of the int4 decode kernels
(``csrc/int4_mma.cuh``) fed the way the decode feeds it: ``S`` is the depth
of the producer warp's TMA ring, ``nblk`` the packed columns of a stage and
of a work item (``nblk / 128`` boxes of ``kc`` = 64 weight rows each).  A
line per variant: kc, microseconds per matvec, the weight bytes per second,
and their share of the card's data-sheet memory rate.
"""

from __future__ import annotations

import statistics
from typing import Callable, List

import torch

from dynam3d_torch.device import DeviceLike, mem_rate, resolve_device
from dynam3d_torch.ops.int4 import pack_int4
from dynam3d_torch.ops.int4_stream import KC, ROWS, STREAM_VARIANTS, int4_stream_matvec, plan

D, N, NW, DBLK = 3072, 16384, 4, 1024


def make_weights(d: int = D, n: int = N, nw: int = NW, dblk: int = DBLK, seed: int = 0,
                 device: DeviceLike = None):
    """``(x [8, d] bf16, q4 [nw, d, n/2], s_lo, s_hi)``: ``nw`` weights of
    std 0.05 packed by ``pack_int4`` and stacked, made on ``device`` (the card
    unless ``device="cpu"``) from ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    packs = [pack_int4(torch.randn(d, n, generator=gen, device=device) * 0.05, dblk=dblk)
             for _ in range(nw)]
    x = torch.randn(ROWS, d, generator=gen, device=device).to(torch.bfloat16)
    return (x, torch.stack([p.q4 for p in packs]), torch.stack([p.s_lo for p in packs]),
            torch.stack([p.s_hi for p in packs]))


def feed_back(y: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """The chain's next input from the last weight's ``y``: ``bf16(xq +
    1e-12 * (lo[:, :d] + hi[:, :d]))``, a data dependence that leaves x."""
    d = xq.shape[1]
    return torch.add(xq, y[:, :d] + y[:, d:2 * d], alpha=1e-12).to(torch.bfloat16)


def make_chain(n: int, *, S: int, nblk: int, dblk: int = DBLK) -> Callable:
    """``n`` dependent matvec steps on kernel I (its plain version on CPU
    tensors); each step streams every stacked weight."""
    def f(xq, q4, sl, sh):
        acc = xq
        for _ in range(n):
            y = int4_stream_matvec(acc, q4, sl, sh, S=S, nblk=nblk, dblk=dblk)[-1]
            acc = feed_back(y, xq)
        return acc
    return f


def _graph(f: Callable, args) -> "torch.cuda.CUDAGraph":
    """``f(*args)`` captured as a CUDA graph, after one warm call (which
    builds the kernel and its launch state): the chain then runs on the card
    without the host, as the TPU tool's jitted chain does."""
    f(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        f(*args)
    return g


def _replay_ms(g: "torch.cuda.CUDAGraph") -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def slope_us(mk: Callable[[int], Callable], args, nw: int, n1: int = 32, n2: int = 160,
             reps: int = 7) -> float:
    """Microseconds per single-weight matvec: the slope between chains of
    ``n1`` and ``n2`` steps (``nw`` weights each), medians of ``reps``
    replays of each chain's CUDA graph.  The launch counters see the warm
    and the captured chain; replays launch the captured kernels again."""
    if not args[0].is_cuda:
        raise RuntimeError("slope_us times the card: it needs CUDA tensors")
    g1, g2 = _graph(mk(n1), args), _graph(mk(n2), args)
    t1s = [_replay_ms(g1) for _ in range(reps)]
    t2s = [_replay_ms(g2) for _ in range(reps)]
    return (statistics.median(t2s) - statistics.median(t1s)) * 1e3 / ((n2 - n1) * nw)


def rate_line(label: str, us: float, nbytes: int, rate: float) -> str:
    gbs = nbytes / us / 1e3
    return f"{label}: {us:7.1f} us/mv  {gbs:6.0f} GB/s  ({gbs * 1e9 / rate * 100:4.1f}% peak)"


def card(device: DeviceLike):
    """The CUDA device to time on; raises without one."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the sweep times the card: it needs a CUDA device")
    return device


def sweep(variants=STREAM_VARIANTS, d: int = D, n: int = N, nw: int = NW, dblk: int = DBLK,
          seed: int = 0, device: DeviceLike = None, log: Callable = print) -> List[dict]:
    """Time every (S, nblk) variant of kernel I; one line and one dict each."""
    device = card(device)
    x, q4, sl, sh = make_weights(d, n, nw, dblk, seed, device)
    rate = mem_rate(torch.cuda.get_device_name(device))
    nbytes = d * (n // 2)                      # one weight's packed bytes
    rows = []
    for S, nblk in variants:
        kslice = plan(q4, "andtrick", S, nblk, dblk).kslice
        us = slope_us(lambda k, S=S, nblk=nblk: make_chain(k, S=S, nblk=nblk, dblk=dblk),
                      (x, q4, sl, sh), nw)
        log(rate_line(f"S={S} nblk={nblk:4d} kc={KC:3d}", us, nbytes, rate))
        rows.append(dict(S=S, nblk=nblk, kc=KC, kslice=kslice, us_per_mv=us,
                         gb_per_s=nbytes / us / 1e3, peak_share=nbytes / us * 1e6 / rate))
    return rows


def main() -> None:
    sweep()


if __name__ == "__main__":
    main()
