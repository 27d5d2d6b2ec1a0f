"""A/B the block bodies of the streamed int4 matvec (kernel J,
``ops/int4_stream.py``) on the card, at S = 2, nblk = 512.

    python -m dynam3d_torch.tools.bench_int4_unpack

Port of ``tools/bench_int4_unpack.py``, timed as ``bench_int4_stream`` times
(NW = 4 weights per chain step, slope of 32 vs 160 steps):

  dma-floor : the same TMA ring; wait on every stage, write the first 8
              weight rows: the ring's streaming ceiling
  current   : signed-lo bytes: the exact nibbles (the low one takes the
              ^ 8 of the high one), bf16 mma.sync, f32 sums
  andtrick  : biased-lo bytes: the same fragments, which in exact
              arithmetic are the AND form of ``nibble_matvec_acc`` (kernel
              I's body)
  w4a8      : int8 activations x the raw bytes and their low nibbles, s8
              mma.sync m16n8k32, int32 sums (the AND form literally); the
              chain quantises each row of x once per step, in PyTorch

Each body is fed the byte format it decodes: ``pack_int4`` writes biased-lo
bytes ``16*hi + (lo+8)``, which andtrick and w4a8 read as they are; current
reads ``q4 ^ 8``, the signed-lo form.  (The TPU tool feeds ``q4 ^ 8`` to
andtrick and w4a8 and ``q4`` to current, a format ``pack_int4`` no longer
writes.)  First line: the andtrick vs current check on the same weights.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from dynam3d_torch.device import DeviceLike, mem_rate
from dynam3d_torch.ops.int4_stream import UNPACK_BODIES, int4_unpack_matvec
from dynam3d_torch.tools.bench_int4_stream import (
    D, DBLK, N, NW, card, feed_back, make_weights, rate_line, slope_us,
)


def feed(body: str, q4: torch.Tensor) -> torch.Tensor:
    """The bytes ``body`` decodes: signed-lo for current, biased-lo else."""
    return q4 ^ 8 if body == "current" else q4


def quantize_rows(x: torch.Tensor):
    """Per-row dynamic int8 quantisation: ``(xi int8, sx [rows, 1] f32)``."""
    xf = x.to(torch.float32)
    sx = xf.abs().amax(-1, keepdim=True) / 127.0
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def matvec(acc, q4, sl, sh, *, body: str, dblk: int = DBLK) -> torch.Tensor:
    """The last weight's ``y`` of one step of ``body`` on bf16 ``acc``."""
    if body == "w4a8":
        xi, sx = quantize_rows(acc)
        return int4_unpack_matvec(xi, q4, sl, sh, body=body, dblk=dblk)[-1] * sx
    return int4_unpack_matvec(acc, q4, sl, sh, body=body, dblk=dblk)[-1]


def make_chain(n: int, *, body: str, dblk: int = DBLK) -> Callable:
    """``n`` dependent steps of ``body``; ``q4`` is the biased-lo pack, fed
    to the body in its own format."""
    def f(xq, q4, sl, sh):
        q = feed(body, q4)
        acc = xq
        for _ in range(n):
            acc = feed_back(matvec(acc, q, sl, sh, body=body, dblk=dblk), xq)
        return acc
    return f


def check(x, q4, sl, sh, dblk: int = DBLK, log: Callable = print) -> float:
    """andtrick on the biased-lo bytes against current on the signed-lo
    bytes, the last weight's whole ``y``; returns the largest difference."""
    y_base = matvec(x, feed("current", q4), sl, sh, body="current", dblk=dblk)
    y_trick = matvec(x, q4, sl, sh, body="andtrick", dblk=dblk)
    err = (y_trick - y_base).abs()
    log(f"andtrick vs current: max abs {err.max().item():.4f} "
        f"max rel-ish {(err / (y_base.abs() + 1.0)).max().item():.4f}")
    return err.max().item()


def sweep(bodies=UNPACK_BODIES, d: int = D, n: int = N, nw: int = NW, dblk: int = DBLK,
          seed: int = 0, device: DeviceLike = None, log: Callable = print) -> List[dict]:
    """The check, then every body timed; one line and one dict each."""
    device = card(device)
    x, q4, sl, sh = make_weights(d, n, nw, dblk, seed, device)
    check(x, q4, sl, sh, dblk, log)
    rate = mem_rate(torch.cuda.get_device_name(device))
    nbytes = d * (n // 2)
    rows = []
    for body in bodies:
        us = slope_us(lambda k, body=body: make_chain(k, body=body, dblk=dblk),
                      (x, q4, sl, sh), nw)
        log(rate_line(f"{body:9s}", us, nbytes, rate))
        rows.append(dict(body=body, us_per_mv=us, gb_per_s=nbytes / us / 1e3,
                         peak_share=nbytes / us * 1e6 / rate))
    return rows


def main() -> None:
    sweep()


if __name__ == "__main__":
    main()
