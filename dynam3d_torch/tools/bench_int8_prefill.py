"""The prefill products at Phi-3-mini's shapes in bf16 and in int8: is W8A8
worth it on the card?

    python -m dynam3d_torch.tools.bench_int8_prefill [--tokens 896]

Port of ``tools/bench_int8_prefill.py``; ``DYNAM3D_PREFILL_T`` is
``--tokens``.  For qkv (3072 x 9216), gate_up (3072 x 16384) and down
(8192 x 3072) at ``--tokens`` rows:

  bf16 : bf16 x bf16 with an f32 result, on the int8 weights dequantized
         to bf16 (``torch.mm(..., out_dtype=torch.float32)``; where this
         PyTorch lacks it, a bf16 product read as f32, and the line says
         so);
  w8a8 : the prefill's own path (``phi3._mm``): per-token max-abs int8
         activations, ``torch._int_mm`` against the column-major int8
         weight, the f32 rescale; the quantization is timed, since serving
         pays it.

Each is the mean device ms of a call after an L2 read flush (CUDA events,
``decompose_int4_mma``'s timer), printed as µs per product and TFLOP/s,
beside the median relative error of w8a8 against bf16.  These products
are library calls (the TPU reference has no Pallas kernel for them).  One
JSON line a shape, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card

SHAPES = (("qkv", 3072, 9216), ("gate_up", 3072, 16384), ("down", 8192, 3072))


def _bf16_f32(a, w):
    try:
        return torch.mm(a, w, out_dtype=torch.float32), "mm out_dtype=float32"
    except (TypeError, RuntimeError):
        return torch.mm(a, w).float(), "bf16 mm read as float32"


def run(dev, T: int = 896, iters: int = 20, seed: int = 0) -> Dict:
    from dynam3d_torch.models.vlm import phi3

    line = card.card_line(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = card.read_flush() if dev.type == "cuda" else None
    out = {}
    for name, d, n in SHAPES:
        x = torch.randn(T, d, generator=gen, device=dev).to(torch.bfloat16)
        wf = torch.randn(d, n, generator=gen, device=dev) * 0.02
        scale = torch.clamp(wf.abs().amax(0, keepdim=True) / 127.0, min=1e-8)
        qi = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        pack = {"q": qi.t().contiguous().t(), "s": scale}
        w_bf = (qi.float() * scale).to(torch.bfloat16)
        del wf
        y_bf, how = _bf16_f32(x, w_bf)
        y_i8 = phi3._mm(pack, x, out_dtype=torch.float32)
        rel = float(((y_i8 - y_bf).abs() / y_bf.abs().clamp(min=1e-3)).median())
        flops = 2.0 * T * d * n
        ms_bf = card.kernel_ms(lambda: _bf16_f32(x, w_bf), dev, flush, iters)
        ms_i8 = card.kernel_ms(lambda: phi3._mm(pack, x, out_dtype=torch.float32), dev,
                               flush, iters)

        def rate(ms):
            return None if ms is None else flops / (ms * 1e-3) / 1e12

        out[name] = card.emit({
            "tool": "bench_int8_prefill", "shape": [T, d, n], "name": name, "bf16_call": how,
            "bf16_us": None if ms_bf is None else ms_bf * 1e3, "bf16_tflops": rate(ms_bf),
            "w8a8_us": None if ms_i8 is None else ms_i8 * 1e3, "w8a8_tflops": rate(ms_i8),
            "w8a8_median_rel_err": rel}, line)
        del x, qi, pack, w_bf, y_bf, y_i8
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tokens", type=int, default=896)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    return run(resolve_device(args.device or device), args.tokens, args.iters)


if __name__ == "__main__":
    main()
