"""Where a Phi-3-mini prefill's time goes: a T = 816 prompt into a cache of
1024 rows, split into its parts, each beside its operations or bytes
bound.

    python -m dynam3d_torch.tools.prof_prefill [--tokens 816] [--cache 1024]

Port of ``tools/prof_prefill.py``.  Parts (each the mean device ms of a
call after an L2 read flush, CUDA events, ``decompose_int4_mma``'s timer):

  forward_w8a8        : ``phi3.forward`` as the prefill runs it (a fresh
                        cache, the lm_head at the last position), W8A8:
                        per-token int8 activations, ``torch._int_mm``;
  forward_weight_only : the same with int8 weights only (dequantized to
                        bf16, an f32 product);
  matmuls_w8a8, matmuls_weight_only : the four products of every layer
                        (qkv, o, gate_up, down) x 32;
  attention           : the attention core x 32 (f32 einsum, masked
                        softmax, einsum over the 1024 cache rows);
  glue                : x 32 two RMSNorms, RoPE of q and k, the cache
                        write of k and v, two residual adds;
  lm_head_all_T, lm_head_last : the lm_head over every position (W8A8)
                        and over the last one alone (kernel A).

Bounds at the H100 SXM's dense peaks: 1979 TOPS int8, and 67 TFLOP/s f32
for the weight-only products and the attention (both f32 products here:
``dot_f32`` and the f32 einsum; in bf16 they would be bounded at 989
TFLOP/s), and the card's memory rate for the glue and the last-position
lm_head.
``attributed`` is the sum of the W8A8 matmuls, attention, glue and the
last-position lm_head; ``unattributed`` what the forward takes beyond it.
One JSON line a part, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def _w8a8(on: bool):
    """The prefill's W8A8 switch for a block (``flags.W8A8_PREFILL``)."""
    import contextlib

    from dynam3d_torch import flags

    @contextlib.contextmanager
    def switch():
        old, flags.W8A8_PREFILL = flags.W8A8_PREFILL, on
        try:
            yield
        finally:
            flags.W8A8_PREFILL = old
    return switch()


def parts(params, cfg, dev, T: int, total: int):
    """name -> (call, work): ``work`` is ``("ops", n, peak)`` or
    ``("bytes", n)``; the calls read the W8A8 switch as they run."""
    from dynam3d_torch.models.vlm import phi3

    D, L, hd = cfg.hidden_size, cfg.num_layers, cfg.head_dim
    H, Hkv, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(1, T, D, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    valid = torch.ones(1, T, dtype=torch.bool, device=dev)
    positions = torch.arange(T, device=dev)[None]
    mask = phi3.prefill_mask(valid, total)
    last = torch.full((1,), T - 1, device=dev)
    layers = params["layers"]

    def forward():
        cache = phi3.init_cache(cfg, 1, total, dtype=x.dtype, device=dev)
        return phi3.forward(params, cfg, x, positions, cache, 0, mask, lm_at=last)[0]

    def matmuls():
        a = x
        for p in layers:
            qkv = phi3._mm(p["qkv"], a)
            a2 = phi3._mm(p["o"], qkv[..., :H * hd])
            gate, up = phi3._mm(p["gate_up"], a2).chunk(2, dim=-1)
            a = a + 1e-12 * phi3._mm(p["down"], torch.nn.functional.silu(gate) * up)
        return a

    kk = torch.nn.functional.pad(x.view(1, T, H, hd), (0, 0, 0, 0, 0, total - T))

    def attention():
        a = x
        for _ in layers:
            q = a.view(1, T, H, hd)
            lg = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(hd)
            lg = lg.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, -1).to(a.dtype).float(),
                             kk.float())
            a = a + 1e-12 * o.reshape(1, T, D).to(a.dtype)
        return a

    ck = torch.zeros(1, total, Hkv, hd, dtype=x.dtype, device=dev)
    cv = torch.zeros_like(ck)

    def glue():
        a = x
        for p in layers:
            h = phi3.rms_norm(p["input_ln"], a, cfg.rms_eps)
            q = phi3._rope(h.view(1, T, H, hd), positions, cfg.rope_theta)
            k = phi3._rope(h[..., :Hkv * hd].reshape(1, T, Hkv, hd), positions, cfg.rope_theta)
            ck[:, :T], cv[:, :T] = k, h[..., :Hkv * hd].reshape(1, T, Hkv, hd)
            a = a + 1e-12 * q.reshape(1, T, D)
            a = a + 1e-12 * phi3.rms_norm(p["post_ln"], a, cfg.rms_eps)
        return a

    mm_ops = 2.0 * T * (D * (H + 2 * Hkv) * hd + H * hd * D + D * 2 * I + I * D) * L
    attn_ops = 2 * 2.0 * T * total * H * hd * L
    act = T * D * 2                     # one bf16 activation
    # per layer: two norms (read, write), RoPE of q and k (read, write), the
    # cache write of k and v, two residual adds (two reads, one write)
    glue_bytes = L * (2 * 2 * act + 2 * act + 2 * (Hkv * hd * T * 2) * 2 + 2 * 3 * act)
    lm = params["lm_head"]
    lm_last = lm["q4"].q4.numel() + 4 * (lm["q4"].s_lo.numel() + lm["q4"].s_hi.numel())
    lm_ops = 2.0 * T * D * V
    return {
        "forward_w8a8": (forward, True, ("sum", ["matmuls_w8a8", "attention", "glue",
                                                 "lm_head_last"])),
        "forward_weight_only": (forward, False, ("sum", ["matmuls_weight_only", "attention",
                                                        "glue", "lm_head_last"])),
        "matmuls_w8a8": (matmuls, True, ("ops", mm_ops, card.INT8_PEAK)),
        "matmuls_weight_only": (matmuls, False, ("ops", mm_ops, card.FP32_PEAK)),
        "attention": (attention, True, ("ops", attn_ops, card.FP32_PEAK)),
        "glue": (glue, True, ("bytes", glue_bytes)),
        "lm_head_all_T": (lambda: phi3._lm_head(params, x), True,
                          ("ops", lm_ops, card.INT8_PEAK)),
        "lm_head_last": (lambda: phi3._lm_head(params, x[:, -1:]), True, ("bytes", lm_last)),
    }


def run(params, cfg, dev, T: int = 816, total: int = 1024, iters: int = 3) -> Dict:
    line = card.card_line(dev)
    flush = card.read_flush() if dev.type == "cuda" else None
    out, bounds = {}, {}
    table = parts(params, cfg, dev, T, total)
    # the parts first, so each forward's bound can sum theirs
    for name in sorted(table, key=lambda n: n.startswith("forward")):
        fn, w8a8, work = table[name]
        with _w8a8(w8a8):
            ms = card.kernel_ms(fn, dev, flush, iters)
        if work[0] == "ops":
            bound, by = work[1] / work[2] * 1e3, "operations"
        elif work[0] == "bytes":
            bound, by = card.bytes_bound_ms(work[1], dev), "bytes"
        else:
            parts_b = [bounds[p] for p in work[1]]
            bound = None if None in parts_b else sum(parts_b)
            by = "sum of its parts' bounds"
        bounds[name] = bound
        out[name] = card.emit({"tool": "prof_prefill", "part": name, "tokens": T,
                               "cache": total, "ms": ms, "bound_ms": bound, "bound_by": by,
                               "share_of_bound": None if ms is None or bound is None
                               else bound / ms}, line)
    ms = {k: v["ms"] for k, v in out.items()}
    if None not in ms.values():
        att = ms["matmuls_w8a8"] + ms["attention"] + ms["glue"] + ms["lm_head_last"]
        out["attribution"] = card.emit({"tool": "prof_prefill", "part": "attribution",
                                        "attributed_ms": att,
                                        "unattributed_ms": ms["forward_w8a8"] - att}, line)
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tokens", type=int, default=816)
    p.add_argument("--cache", type=int, default=1024)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    cfg, params = card.int4_phi3(args.seed, dev)
    return run(params, cfg, dev, args.tokens, args.cache, args.iters)


if __name__ == "__main__":
    main()
