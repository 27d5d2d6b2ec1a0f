"""Where kernels B (``csrc/decode_attn.cu``) and H
(``csrc/decode_attn_layer.cu``) spend their time, on the card.

    python -m dynam3d_torch.tools.decompose_decode_attn
    python -m dynam3d_torch.tools.decompose_decode_attn --parent DIR

Each variant is a copy of the package under ``build/decompose_attn/<variant>/``
(gitignored; each copy builds its kernels into its own ``build/``) whose
sources are patched.  The patches depend on the design the copy holds:
``split`` (the split-sequence tensor-core body of ``csrc/decode_attn.cuh``)
or ``per_row`` (the design before it: each thread of a block per (row,
head) streamed whole cache rows on the CUDA cores, H's matvecs on
``int4_tile.cuh``).

  asis       : unchanged;
  h1, h2, h3 : kernel H runs only its phase 1 (rmsnorm + qkv), 2
               (attention) or 3 (o + residual); the other phases' work
               loops run no item, the grid barriers stay;
  hsync      : kernel H runs no phase: the launch and its two barriers;
  nomath     : the cache bytes are read as they are, but no score, softmax
               or context arithmetic runs (split: the consumer warps xor a
               word of each landed stage; per_row: an xor of the loaded
               words stands in for each row's arithmetic);
  nostream   : no cache byte is read (split: the producer arrives on each
               stage's barrier without copying; per_row: the loads are
               replaced by values made from the indices).
Under the split design ``nomath`` and ``nostream`` patch the body that B
and H share, so H's line moves too; under ``per_row`` they patch B alone.

Every variant runs in a process of its own, in the order of ``ORDER``
(``asis`` first and last: the repeat shows the spread); with ``--parent
DIR`` the parent checkout's variants run first, in the same order, then
this tree's.  Each prints one JSON line: the mean device ms
of kernel H at Phi-3-mini widths (D = 3072, 32 heads of 96, Tmax = 1024,
write slot 900 with two holes: ``chip_smoke.py``'s ``attn`` shape) and of
kernel B in its three modes (plain B=1, shared-cache k=8, grouped B=4 /
group 2; Tmax = 1024, ~880 live rows: the ``ring`` shapes), each call after
a 96 MB L2 flush (a read), by CUDA events, the flushes subtracted
(``decompose_int4_mma._time_ms``).  The first line is the card's name and
power limit.  Under the split design the ``asis`` lines also time kernel
B with its splits per (head, group) forced to each of ``SPLITS``.  Without
a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from dynam3d_torch.tools.decompose_int4_mma import PACKAGE, ROOT, _time_ms, _variant, read_flush

WORK = ROOT / "build" / "decompose_attn"
ORDER = ("asis", "h1", "h2", "h3", "hsync", "nomath", "nostream", "asis")
SPLITS = (1, 2, 4, 8, 16)   # kernel B's splits per (head, group), swept under the split design


def _skip(source, *names):
    return [(source, f"const int {n} = ", f"const int {n} = 0 * ") for n in names]


# per design: variant -> [(source in csrc/, the text replaced, its replacement)]
PATCHES = {
    "split": {
        "h1": _skip("decode_attn_layer.cu", "items2", "items3"),
        "h2": _skip("decode_attn_layer.cu", "items1", "items3"),
        "h3": _skip("decode_attn_layer.cu", "items1", "items2"),
        "hsync": _skip("decode_attn_layer.cu", "items1", "items2", "items3"),
        "nomath": [("decode_attn.cuh", "  if constexpr (kMath) {", "  if constexpr (false) {")],
        "nostream": [("decode_attn.cuh", "  if constexpr (kStream) {", "  if constexpr (false) {")],
    },
    "per_row": {
        "h1": [("decode_attn_layer.cu", "h < p.heads;", "h < 0;"),
               ("decode_attn_layer.cu", "item < tiles3 * ns3;", "item < 0;")],
        "h2": [("decode_attn_layer.cu", "item < tiles1 * ns1;", "item < 0;"),
               ("decode_attn_layer.cu", "item < tiles3 * ns3;", "item < 0;")],
        "h3": [("decode_attn_layer.cu", "item < tiles1 * ns1;", "item < 0;"),
               ("decode_attn_layer.cu", "h < p.heads;", "h < 0;")],
        "hsync": [("decode_attn_layer.cu", "item < tiles1 * ns1;", "item < 0;"),
                  ("decode_attn_layer.cu", "h < p.heads;", "h < 0;"),
                  ("decode_attn_layer.cu", "item < tiles3 * ns3;", "item < 0;")],
        "nomath": [("decode_attn.cu", """#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f2 = __bfloat1622float2(p2[u]);
        s = fmaf(q_s[v8 * 8 + 2 * u], f2.x, s);
        s = fmaf(q_s[v8 * 8 + 2 * u + 1], f2.y, s);
      }""", """      s += __uint_as_float((w.x ^ w.y ^ w.z ^ w.w ^ __float_as_uint(__low2float(p2[0]))) & 0x3f800000u);"""),
                   ("decode_attn.cu", """    s *= scale;
    float alpha = 1.f, p;
    if (s > m) { alpha = expf(m - s); m = s; p = 1.f; }
    else { p = expf(s - m); }
    l = l * alpha + p;""", """    l += s;"""),
                   ("decode_attn.cu", """#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f2 = __bfloat1622float2(p2[u]);
        acc[v8 * 8 + 2 * u] = fmaf(acc[v8 * 8 + 2 * u], alpha, p * f2.x);
        acc[v8 * 8 + 2 * u + 1] = fmaf(acc[v8 * 8 + 2 * u + 1], alpha, p * f2.y);
      }""", """      acc[v8] += __uint_as_float((w.x ^ w.y ^ w.z ^ w.w ^ __float_as_uint(__low2float(p2[0]))) & 0x3f800000u);""")],
        "nostream": [("decode_attn.cu", "const uint4 w = __ldg(kp + v8);",
                      "const uint4 w = make_uint4(t, v8, 0x3f80u, t ^ v8); (void)kp;"),
                     ("decode_attn.cu", "const uint4 w = __ldg(vp + v8);",
                      "const uint4 w = make_uint4(v8, t, 0x3f80u, t + v8); (void)vp;")],
    },
}


def design(package: Path) -> str:
    """``split`` when the package holds the split-sequence attention body."""
    return "split" if (package / "csrc" / "decode_attn.cuh").exists() else "per_row"


def _copy(name: str, package: Path, tag: str = "") -> Path:
    return _variant(f"{tag}{name}", WORK, {f"{tag}{name}": PATCHES[design(package)].get(name, [])},
                    package)


def measure(name: str) -> dict:
    """This process's package (a variant's copy) on the card; the ``asis``
    variant of the split design also times kernel B at each of ``SPLITS``."""
    import dynam3d_torch
    from dynam3d_torch.ops import decode
    from dynam3d_torch.ops.decode import decode_attn_cuda, decode_attn_layer_cuda, scan_length
    from dynam3d_torch.ops.int4 import int4_matvec_plain, pack_int4

    if Path(dynam3d_torch.__file__).resolve().parents[1] != Path.cwd().resolve():
        raise RuntimeError("decompose: the variant did not import its own copy of the package")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = read_flush()
    D, H, hd, tmax = 3072, 32, 96, 1024
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    freqs = 10000.0 ** (-torch.arange(0, hd // 2, device=dev, dtype=torch.float32) / (hd // 2))
    t = torch.arange(tmax, device=dev)
    qkv, o = pack_int4(randn(D, 3 * D) * 0.02), pack_int4(randn(D, D) * 0.02)
    ln_w = 1.0 + 0.1 * randn(D)
    out = {}
    # kernel H: the attn phase's shapes
    x = randn(1, 1, D).to(torch.bfloat16)
    ck, cv = randn(2, 1, tmax, D).to(torch.bfloat16), randn(2, 1, tmax, D).to(torch.bfloat16)
    pos = 900
    mask = (t < pos) & ~((t >= 100) & (t < 120)) & ~((t >= 600) & (t < 611))
    ang = (pos - 31) * freqs
    args = (x, ln_w, qkv, o, ck, cv, 1, pos, mask, torch.cos(ang), torch.sin(ang))
    out["H"] = _time_ms(lambda: decode_attn_layer_cuda(*args, eps=1e-5, heads=H, hd=hd), flush)
    # kernel B: the ring phase's modes
    for mode, B, group, pos_rows in (("plain", 1, 1, [900]), ("shared_cache", 8, 8, [900] * 8),
                                     ("group_size", 4, 2, [900, 900, 905, 905])):
        nc = B // group
        ck = randn(1, nc, tmax, D).to(torch.bfloat16)
        cv = randn(1, nc, tmax, D).to(torch.bfloat16)
        mask = torch.stack([(t < p) & ~((t >= 100) & (t < 120)) for p in pos_rows])
        rp = torch.tensor([p - 20 + (i % group) for i, p in enumerate(pos_rows)], device=dev,
                          dtype=torch.float32)
        ang = rp[:, None] * freqs
        y = int4_matvec_plain(randn(B, D).to(torch.bfloat16), qkv, ln_w=ln_w, eps=1e-5)
        a = (y, torch.cos(ang), torch.sin(ang), ck, cv, 0, mask, scan_length(max(pos_rows), tmax),
             group)
        out[f"B {mode}"] = _time_ms(lambda: decode_attn_cuda(*a, heads=H, hd=hd), flush)
        if name.endswith(":asis") and hasattr(decode, "attn_splits"):
            # the same launch at other splits (the plan's attn_splits forced)
            plan_fn = decode.attn_splits
            for ns in SPLITS:
                def forced(slots, pairs, t_scan, ns=ns):
                    tiles = -(-t_scan // decode.TILE)
                    return ns, -(-tiles // ns)

                decode._attn_plans.clear()
                decode.attn_splits = forced
                out[f"B {mode} splits={ns}"] = _time_ms(
                    lambda: decode_attn_cuda(*a, heads=H, hd=hd), flush)
            decode.attn_splits = plan_fn
            decode._attn_plans.clear()
    return out


def _build(dirs) -> None:
    """Build the two kernel libraries of every copy at once, one process per
    copy (each copy's nvcc runs in parallel with the others')."""
    code = ("from dynam3d_torch.ops import kernels\n"
            "for n in ('decode_attn', 'decode_attn_layer'): kernels.library(n)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=d, env=_env(d))
             for d in dict.fromkeys(dirs)]
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("decompose: a variant's kernels did not build")


def _env(d: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(d)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose package is decomposed before this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decompose_decode_attn times the card: it needs a CUDA device")
    if args.measure:
        print(json.dumps(dict(variant=args.measure, ms=measure(args.measure))), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    runs = []   # (label, copy) in the order they are timed
    if args.parent is not None:
        parent = args.parent.resolve() / PACKAGE.name
        runs += [(f"parent:{v}", _copy(v, parent, "parent_")) for v in ORDER]
    runs += [(f"{design(PACKAGE)}:{v}", _copy(v, PACKAGE)) for v in ORDER]
    copies = dict(runs)
    _build(copies.values())
    for label, _ in runs:
        d = copies[label]
        # this file's measure() against the copy's package
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", label],
                       cwd=d, env=_env(d), check=True)


if __name__ == "__main__":
    main()
