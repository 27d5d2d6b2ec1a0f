"""The kernel timers' L2 flush by a write and by a read, side by side:
kernel A at the lm_head (3072 x 32064, 1 row) and kernel F (Phi-3-mini MLP,
3072 x 8192, 12 rows), each timed after either flush, in the order write,
read, read, write.

    python -m dynam3d_torch.tools.flush_pair

The write flush is a 96 MB ``zero_()``: it leaves dirty lines in L2 that
the timed call's reads must first write back.  The read flush
(:func:`decompose_int4_mma.read_flush`, the one ``chip_smoke.py`` times
with) sums a 96 MB buffer and leaves none.  The first line is the card's
name and power limit, then one JSON line per (flush, kernel): mean device
ms of 20 calls by CUDA events, the flushes subtracted.  Without a card it
raises.
"""

from __future__ import annotations

import json
import subprocess

import torch

from dynam3d_torch.tools.decompose_int4_mma import _time_ms, read_flush


def write_flush():
    buf = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    buf.zero_()
    torch.cuda.synchronize()
    return buf.zero_


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("flush_pair: no CUDA device")
    from dynam3d_torch.ops.int4 import int4_matvec_cuda, int4_mlp_cuda, pack_int4

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = pack_int4(torch.randn(3072, 32064, generator=gen, device="cuda") * 0.02)
    gu = pack_int4(torch.randn(3072, 16384, generator=gen, device="cuda") * 0.02)
    dn = pack_int4(torch.randn(8192, 3072, generator=gen, device="cuda") * 0.02)
    x1 = torch.randn(1, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    x12 = torch.randn(12, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    calls = {"A lm_head rows=1": lambda: int4_matvec_cuda(x1, lm),
             "F rows=12": lambda: int4_mlp_cuda(x12, gu, dn)}
    flushes = {"write": write_flush(), "read": read_flush()}
    for name in ("write", "read", "read", "write"):
        for kernel, fn in calls.items():
            ms = _time_ms(fn, flushes[name])
            print(json.dumps(dict(flush=name, kernel=kernel, ms=ms)), flush=True)


if __name__ == "__main__":
    main()
