"""Where kernels A, F, G, I and J spend their time: the tensor-core body
(``csrc/int4_mma.cuh``, and I and J's loop in ``csrc/int4_stream.cu``)
timed as it is, without its math, without its weight stream and without
the ordered sum of its K slices, on the card.

    python -m dynam3d_torch.tools.decompose_int4_mma
    python -m dynam3d_torch.tools.decompose_int4_mma --parent DIR

Each variant is a copy of the package under ``build/decompose/<variant>/``
(gitignored; each copy builds its kernels into its own ``build/``) whose
sources are patched:

  asis      : unchanged;
  nomath    : the consumer warps wait for each stage and release it without
              building fragments or running mma (an xor of the loaded
              words stands in, so the shared loads stay); in I and J the
              bf16 bodies' loop;
  nostream  : the producer arrives on each stage's full barrier without
              copying; the consumers multiply whatever the slots hold;
  nosum     : every kernel skips the ordered sum of its K slices
              (``split_sum``, which A, E, F and G reach through
              ``finish``): each block returns its slice's sums as the
              item's; no workspace, no ticket, no last-block sum; y is
              wrong.

Every variant runs in a process of its own, in the order asis, nomath,
nostream, nosum, asis (the repeat shows the spread).  With ``--parent
DIR`` the tool instead times the package of the checkout ``DIR`` beside
this one, both unpatched, in the order parent, asis, asis, parent (this
file's timings run against either package).  Each prints one JSON line:
the mean device ms of kernel A at the lm_head (3072 x 32064), o (3072 x
3072) and down (8192 x 3072) shapes at 1, 8 and 16 rows, of kernel F at
Phi-3-mini widths at 12 rows and of G at 1 row, of kernel I at the int4 tools' shapes (4
weights of 3072 x 16384, 8 rows) for every ``STREAM_VARIANTS`` entry and
of kernel J's dma-floor and current bodies at S = 2, nblk = 512 (w4a8's
loop is not patched: its nomath line is as is), each call after a 96 MB
L2 flush (a read), by CUDA events, the flushes subtracted (the timing of
``chip_smoke.py``).  The first line is the card's name and power limit.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
WORK = ROOT / "build" / "decompose"
ORDER = ("asis", "nomath", "nostream", "nosum", "asis")
PARENT_ORDER = ("parent", "asis", "asis", "parent")

# (source in csrc/, the text the variant replaces, its replacement)
PATCHES = {
    "nomath": [("int4_mma.cuh", """    uint32_t b[NT][2];
    b_frags<NT>(xs, kx + q * 16, b);
    uint32_t a[4][4];
    a_frags(w[0], w[1], w[2], w[3], a);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < 4; ++m) mma_bf16(acc.c[n][m], a[m], b[n][0], b[n][1]);""",
                """    acc.c[0][0][0] += __uint_as_float((w[0] ^ w[1] ^ w[2] ^ w[3]) & 0x3f800000u);"""),
               ("int4_stream.cu", """          a_frags<BODY == kCurrent>(wv[0], wv[1], wv[2], wv[3], a);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_bf16(acc[b].c[0][m], a[m], bf[0][0], bf[0][1]);""",
                """          acc[b].c[0][0][0] +=
              __uint_as_float((wv[0] ^ wv[1] ^ wv[2] ^ wv[3] ^ bf[0][0]) & 0x3f800000u);""")],
    "nostream": [("int4_mma.cuh", """    mbar_expect_tx(&r.full[slot], (uint32_t)(boxes * kSlotBytes));
    // order the consumers' generic reads of the slot before the async write
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    for (int b = 0; b < boxes; ++b)
      tma_box(r.buf + (slot * boxes + b) * kSlotBytes, map, col0 + b * kCols, k, &r.full[slot]);""",
                  """    mbar_arrive(&r.full[slot]);""")],
    "nosum": [("int4_mma.cuh", """                                          int* is_last) {
  if (nsplit == 1) return true;""", """                                          int* is_last) {
  return true;""")],
}


def _variant(name: str, work: Path = WORK, patches: dict = PATCHES,
             package: Path = PACKAGE) -> Path:
    """A copy of ``package`` under ``work / name`` with ``name``'s patches
    applied; raises when a source no longer holds the patched text."""
    dst = work / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(package, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in patches.get(name, ()):
        src = dst / PACKAGE.name / "csrc" / source
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
    from dynam3d_torch.ops.int4 import (
        int4_matvec_cuda, int4_mlp_block_cuda, int4_mlp_cuda, pack_int4,
    )
    from dynam3d_torch.ops.int4_stream import (
        STREAM_VARIANTS, int4_stream_matvec_cuda, int4_unpack_matvec_cuda,
    )
    from dynam3d_torch.tools.bench_int4_stream import DBLK, make_weights
    from dynam3d_torch.tools.bench_int4_unpack import feed

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
    x1, ln_w = x[:1].contiguous(), 1.0 + 0.1 * torch.randn(3072, generator=gen, device="cuda")
    out["G rows=1"] = _time_ms(
        lambda: int4_mlp_block_cuda(x1, ln_w, gu, dn, 1e-5, out_dtype=torch.bfloat16), flush)
    del gu, dn
    x, q4, sl, sh = make_weights(device="cuda")
    for S, nblk in STREAM_VARIANTS:
        out[f"I S={S} nblk={nblk}"] = _time_ms(
            lambda: int4_stream_matvec_cuda(x, q4, sl, sh, S=S, nblk=nblk, dblk=DBLK), flush)
    for body in ("dma-floor", "current"):
        qb = feed(body, q4)
        out[f"J {body}"] = _time_ms(
            lambda: int4_unpack_matvec_cuda(x, qb, sl, sh, body=body, dblk=DBLK), flush)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose package is timed beside this one, unpatched")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decompose_int4_mma times the card: it needs a CUDA device")
    if args.measure:
        print(json.dumps(dict(variant=args.measure, ms=measure())), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    if args.parent is not None:
        order = PARENT_ORDER
        dirs = {"parent": _variant("parent", package=args.parent.resolve() / PACKAGE.name),
                "asis": _variant("asis")}
    else:
        order = ORDER
        dirs = {name: _variant(name) for name in dict.fromkeys(ORDER)}
    for name in order:
        # this file's measure() against the copy's package
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", name],
                       cwd=dirs[name], env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                           [str(dirs[name])] + [p for p in [os.environ.get("PYTHONPATH")] if p])),
                       check=True)


if __name__ == "__main__":
    main()
