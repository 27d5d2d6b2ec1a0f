"""Where kernels A and F spend their time: the tensor-core body
(``csrc/int4_mma.cuh``) timed as it is, without its math and without its
weight stream, on the card.

    python -m dynam3d_torch.tools.decompose_int4_mma

Each variant is a copy of the package under ``build/decompose/<variant>/``
(gitignored; each copy builds its kernels into its own ``build/``) whose
``int4_mma.cuh`` is patched:

  asis      : unchanged;
  nomath    : the consumer warps wait for each stage and release it without
              building fragments or running mma (an xor of the four loaded
              words stands in, so the shared loads stay);
  nostream  : the producer arrives on each stage's full barrier without
              copying; the consumers multiply whatever the slots hold.

Every variant runs in a process of its own, in the order asis, nomath,
nostream, asis (the repeat shows the spread).  Each prints one JSON line:
the mean device ms of kernel A at the lm_head (3072 x 32064), o (3072 x
3072) and down (8192 x 3072) shapes at 1, 8 and 16 rows and of kernel F at
Phi-3-mini widths at 12 rows, each call after a 96 MB L2 flush (a read),
by CUDA events, the flushes subtracted (the timing of ``chip_smoke.py``).
The first line is the card's name and power limit.  Without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
WORK = ROOT / "build" / "decompose"
ORDER = ("asis", "nomath", "nostream", "asis")

# (the text the variant replaces, its replacement) in csrc/int4_mma.cuh
PATCHES = {
    "nomath": ("""    uint32_t b[NT][2];
    b_frags<NT>(xs, kx + q * 16, b);
    uint32_t a[4][4];
    a_frags(w0, w1, w2, w3, a);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < 4; ++m) mma_bf16(acc.c[n][m], a[m], b[n][0], b[n][1]);""",
               """    acc.c[0][0][0] += __uint_as_float((w0 ^ w1 ^ w2 ^ w3) & 0x3f800000u);"""),
    "nostream": ("""    mbar_expect_tx(&r.full[slot], (uint32_t)kSlotBytes);
    // order the consumers' generic reads of the slot before the async write
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    tma_box(r.buf + slot * kSlotBytes, map, col0, k, &r.full[slot]);""",
                 """    mbar_arrive(&r.full[slot]);"""),
}


def _variant(name: str, work: Path = WORK, source: str = "int4_mma.cuh",
             patches: dict = PATCHES) -> Path:
    """A copy of the package under ``work / name`` with ``name``'s patch of
    ``csrc/<source>`` applied; raises when the source no longer holds the
    patched text."""
    dst = work / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(PACKAGE, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if name in patches:
        src = dst / PACKAGE.name / "csrc" / source
        old, new = patches[name]
        text = src.read_text()
        if old not in text:
            raise RuntimeError(f"decompose: the {name} patch no longer applies to {source}")
        src.write_text(text.replace(old, new))
    return dst


def read_flush():
    """An L2 flush that reads a 96 MB buffer (a sum whose result is dropped),
    leaving no dirty lines behind (``chip_smoke.py``'s timer)."""
    buf = torch.zeros(24 * 2**20, dtype=torch.float32, device="cuda")
    out = torch.zeros((), dtype=torch.float32, device="cuda")
    torch.sum(buf, 0, out=out)   # the reduction's first launch loads its module
    torch.cuda.synchronize()
    return lambda: torch.sum(buf, 0, out=out)


def _time_ms(fn, flush, iters: int = 20) -> float:
    """Mean device ms of ``fn`` after each call of ``flush``, flushes
    subtracted.  A GPU sleep ahead of each window holds the card while the
    host enqueues the window, so the wrapper's host time opens no gaps on
    the device."""
    import time

    host_s = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    sleep_cycles = int(2 * iters * (host_s + 20e-6) * 2e9)   # ~2 GHz, twice the enqueue

    def window(call):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(iters):
            flush()
            if call is not None:
                call()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    return max(0.0, (window(fn) - window(None)) / iters)


def measure() -> dict:
    """This process's package (a variant's copy) on the card."""
    import dynam3d_torch
    from dynam3d_torch.ops.int4 import int4_matvec_cuda, int4_mlp_cuda, pack_int4

    if Path(dynam3d_torch.__file__).resolve().parents[1] != Path.cwd().resolve():
        raise RuntimeError("decompose: the variant did not import its own copy of the package")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = read_flush()
    out = {}
    for name, d, n in (("lm_head", 3072, 32064), ("o", 3072, 3072), ("down", 8192, 3072)):
        w = pack_int4(torch.randn(d, n, generator=gen, device="cuda") * 0.02)
        for rows in (1, 8, 16):
            x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
            out[f"A {name} rows={rows}"] = _time_ms(lambda: int4_matvec_cuda(x, w), flush)
    gu = pack_int4(torch.randn(3072, 16384, generator=gen, device="cuda") * 0.02)
    dn = pack_int4(torch.randn(8192, 3072, generator=gen, device="cuda") * 0.02)
    x = torch.randn(12, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    out["F rows=12"] = _time_ms(lambda: int4_mlp_cuda(x, gu, dn), flush)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decompose_int4_mma times the card: it needs a CUDA device")
    if args.measure:
        print(json.dumps(dict(variant=args.measure, ms=measure())), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = {name: _variant(name) for name in dict.fromkeys(ORDER)}
    for name in ORDER:
        subprocess.run([sys.executable, "-m", "dynam3d_torch.tools.decompose_int4_mma",
                        "--measure", name], cwd=dirs[name], check=True)


if __name__ == "__main__":
    main()
