"""Where kernel C (``csrc/nerf_mlp.cu``) spends its time: the kernel timed
as it is, without its tensor-core products, without its exchange between
the blocks of a cluster and without its weight stream, on the card.

    python -m dynam3d_torch.tools.decompose_nerf_mlp

Each variant is a copy of the package under ``build/decompose_nerf/<variant>/``
(gitignored; each copy builds its kernels into its own ``build/``) whose
``nerf_mlp.cu`` is patched:

  asis        : unchanged;
  nomma       : the consumer warpgroups wait for each weight tile and release
                it without issuing wgmma (the accumulators keep their zeros);
  noexchange  : each block writes its epilogue into its own activation tile
                only (no distributed shared memory stores; the cluster
                barriers stay);
  nostream    : the producer arrives on each slot's full barrier without a
                TMA copy; the consumers multiply whatever the slots hold.

Every variant runs in a process of its own, in the order asis, nomma,
noexchange, nostream, asis (the repeat shows the spread).  Each prints one
JSON line: the mean device ms of kernel C at D = 768 on the weights of
``init_render_params`` (cached bf16 copies, as the renderer's later views
find them) at N = 1152 (one view) and 18432 rows, each call after a 96 MB
L2 flush (a read), by CUDA events, the flushes subtracted (the timing of
``chip_smoke.py``).  The first line is the card's name and power limit.
Without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from dynam3d_torch.tools.decompose_int4_mma import ROOT, _time_ms, _variant, read_flush

WORK = ROOT / "build" / "decompose_nerf"
ORDER = ("asis", "nomma", "noexchange", "nostream", "asis")

# (source in csrc/, the text the variant replaces, its replacement)
PATCHES = {
    "nomma": [("nerf_mlp.cu", """        wgmma_tile<WN>(acc, desc(act_s + kt * kKBlockBytes + k * 2 * kKStep),
                       desc(b_s + slot * kSlotBytes + k * 2 * kKStep), kt > 0 || k > 0);""",
               """        ;""")],
    "noexchange": [("nerf_mlp.cu", """        for (int dst = 0; dst < CL; ++dst) *reinterpret_cast<uint4*>(tiles[dst] + off) = chunk;""",
                    """        for (int dst = 0; dst < 1; ++dst) *reinterpret_cast<uint4*>(act + off) = chunk;""")],
    "nostream": [("nerf_mlp.cu", """        mbar_expect_tx(&full[slot], (uint32_t)kSlotBytes);
        tma_box(ring + slot * kSlotBytes, &wmap, (t % KB) * kBK, (t / KB) * D + c0, &full[slot]);""",
                  """        mbar_arrive(&full[slot]);""")],
}


def measure() -> dict:
    """This process's package (a variant's copy) on the card."""
    import dynam3d_torch
    from dynam3d_torch.config import FieldsConfig
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_cuda

    if Path(dynam3d_torch.__file__).resolve().parents[1] != Path.cwd().resolve():
        raise RuntimeError("decompose: the variant did not import its own copy of the package")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = FieldsConfig()
    mlp = init_render_params(gen, cfg, "cuda")["mlp"]
    w = [mlp["enc_hidden"][0], mlp["enc_hidden"][1], mlp["enc_out"], mlp["dec_hidden"][0],
         mlp["dec_hidden"][1], mlp["dec_out"]]
    flush = read_flush()
    out = {}
    for n in (1152, 16 * 1152):
        x = torch.randn(n, cfg.fts_dim, generator=gen, device="cuda")
        out[f"C N={n}"] = _time_ms(lambda: nerf_mlp_cuda(x, *w), flush)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decompose_nerf_mlp times the card: it needs a CUDA device")
    if args.measure:
        print(json.dumps(dict(variant=args.measure, ms=measure())), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = {name: _variant(name, WORK, PATCHES) for name in dict.fromkeys(ORDER)}
    for name in ORDER:
        subprocess.run([sys.executable, "-m", "dynam3d_torch.tools.decompose_nerf_mlp",
                        "--measure", name], cwd=dirs[name], check=True)


if __name__ == "__main__":
    main()
