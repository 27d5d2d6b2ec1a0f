"""Where a decode token's time goes: each part of one Phi-3-mini decode
layer (int4 weights) timed on the card beside its bytes bound, and the
one-step logits of the fused and unfused routes side by side.

    python -m dynam3d_torch.tools.prof_decode_parts [--pos 830] [--tmax 1024]
    python -m dynam3d_torch.tools.prof_decode_parts --device cpu --layers 2

Port of ``tools/prof_decode_parts.py``.  The parts, at layer 0 of a cache
of ``--tmax`` rows with ``--pos`` live rows:

  fused_ring   : the whole-layer ring (kernel B and four kernel A);
  fused_attn   : the split route's attention half (kernel H);
  fused_mlp    : its MLP block (kernel G);
  unfused_attn : kernel A for qkv, PyTorch attention over the cache,
                 kernel A for o and the residual;
  unfused_mlp  : RMSNorm, kernel F, the residual;
  lm_head      : kernel A over the vocabulary and the argmax;
  qkv_only, gate_up_only, down_only : one kernel A each.

Each time is the mean device ms of one call after an L2 read flush (CUDA
events, ``decompose_int4_mma``'s timer), beside the bytes it must move
(the packed weights, the live K/V rows) over the card's memory rate.  Then
one decode step (``decode_forward`` against ``_decode_forward_fused``) from
the same cache: max abs and relative logit difference, argmax agreement
and the unfused top-1 gap (a random-weight near-tie flips ids without a
fault).  One JSON line a part, then the parity line, each with the card's
name and power limit.  On the CPU (``--device cpu``) only the parity is
computed, through the plain versions.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List

import numpy as np
import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def layer_inputs(cfg, dev, tmax: int, pos: int, seed: int = 0):
    """The layer's inputs from numpy ``seed``: x [1, 1, D] bf16, flat caches
    ``[L, 1, tmax, Hkv * hd]`` bf16 (normal, scale 0.1), the live mask
    ``[tmax]`` (rows < pos), RoPE cos / sin at ``pos``, and the step's
    embedding."""
    rng = np.random.default_rng(seed)
    D, L, W = cfg.hidden_size, cfg.num_layers, cfg.num_kv_heads * cfg.head_dim

    def bf(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, torch.bfloat16)

    x = bf(rng.normal(size=(1, 1, D)))
    ck = bf(rng.normal(scale=0.1, size=(L, 1, tmax, W)))
    cv = bf(rng.normal(scale=0.1, size=(L, 1, tmax, W)))
    mask = torch.zeros(tmax, dtype=torch.bool, device=dev)
    mask[:pos] = True
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-np.arange(half) / half)
    cos = torch.as_tensor(np.cos(pos * freqs), dtype=torch.float32, device=dev)
    sin = torch.as_tensor(np.sin(pos * freqs), dtype=torch.float32, device=dev)
    e = bf(rng.normal(size=(1, 1, D)))
    return dict(x=x, ck=ck, cv=cv, mask=mask, cos=cos, sin=sin, e=e)


def parts(params, cfg, inp, pos: int) -> Dict[str, tuple]:
    """name -> (call, bytes it must move) for the parts of layer 0."""
    from dynam3d_torch.models.vlm import phi3
    from dynam3d_torch.ops.decode import decode_attn_layer, decode_layer_ring
    from dynam3d_torch.ops.int4 import int4_matmul, int4_mlp_block

    lp = params["layers"][0]
    D, hd = cfg.hidden_size, cfg.head_dim
    x, ck, cv, mask, cos, sin = (inp[k] for k in ("x", "ck", "cv", "mask", "cos", "sin"))
    dev = x.device
    kw = dict(eps=cfg.rms_eps, heads=cfg.num_heads, hd=hd)
    kv_bytes = pos * D * 2 * 2

    def nbytes(*ws):
        return sum(w["q4"].q4.numel() + 4 * (w["q4"].s_lo.numel() + w["q4"].s_hi.numel())
                   for w in ws)

    # the unfused attention half: qkv, attention over the live rows, o
    keys = ck[0].clone().view(1, -1, cfg.num_kv_heads, hd)
    vals = cv[0].clone().view(1, -1, cfg.num_kv_heads, hd)
    m = mask.clone()
    m[pos] = True
    positions = torch.full((1, 1), pos, device=dev)

    def unfused_attn():
        q, k, v = phi3._qkv(lp, cfg, x, positions)
        keys[:, pos], vals[:, pos] = k[:, 0], v[:, 0]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) / math.sqrt(hd)
        logits = logits.masked_fill(~m[None, None, None], torch.finfo(torch.float32).min)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1).to(x.dtype).float(),
                         vals.float()).reshape(1, 1, D).to(x.dtype)
        return x + phi3._mm(lp["o"], o)

    def unfused_mlp():
        return x + phi3._mlp(lp, phi3.rms_norm(lp["post_ln"], x, cfg.rms_eps))

    def lm_head():
        return phi3._lm_head(params, x).argmax(-1)

    h = torch.as_tensor(np.random.default_rng(1).normal(size=(1, cfg.intermediate_size)),
                        dtype=torch.float32).to(dev, torch.bfloat16)
    attn_w, mlp_w = nbytes(lp["qkv"], lp["o"]), nbytes(lp["gate_up"], lp["down"])
    return {
        "fused_ring": (lambda: decode_layer_ring(
            x, lp["input_ln"], lp["qkv"]["q4"], lp["o"]["q4"], lp["post_ln"],
            lp["gate_up"]["q4"], lp["down"]["q4"], ck, cv, 0, pos, mask, cos, sin, **kw),
            attn_w + mlp_w + kv_bytes),
        "fused_attn": (lambda: decode_attn_layer(
            x, lp["input_ln"], lp["qkv"]["q4"], lp["o"]["q4"], ck, cv, 0, pos, mask, cos, sin,
            **kw), attn_w + kv_bytes),
        "fused_mlp": (lambda: int4_mlp_block(x, lp["post_ln"], lp["gate_up"]["q4"],
                                             lp["down"]["q4"], cfg.rms_eps), mlp_w),
        "unfused_attn": (unfused_attn, attn_w + kv_bytes),
        "unfused_mlp": (unfused_mlp, mlp_w),
        "lm_head": (lm_head, nbytes(params["lm_head"])),
        "qkv_only": (lambda: int4_matmul(x[0], lp["qkv"]["q4"]), nbytes(lp["qkv"])),
        "gate_up_only": (lambda: int4_matmul(x[0], lp["gate_up"]["q4"]), nbytes(lp["gate_up"])),
        "down_only": (lambda: int4_matmul(h, lp["down"]["q4"]), nbytes(lp["down"])),
    }


def measure(params, cfg, dev, tmax: int = 1024, pos: int = 830, iters: int = 20) -> List[Dict]:
    """One record a part: device ms, the bytes bound and its share."""
    inp = layer_inputs(cfg, dev, tmax, pos)
    flush = card.read_flush() if dev.type == "cuda" else None
    rows = []
    for name, (fn, nb) in parts(params, cfg, inp, pos).items():
        ms = card.kernel_ms(fn, dev, flush, iters)
        bound = card.bytes_bound_ms(nb, dev)
        rows.append({"part": name, "ms": ms, "bytes": int(nb), "bound_ms": bound,
                     "share_of_bound": None if ms is None else bound / ms})
    return rows


def step_logits(params, cfg, inp, pos: int, fused: bool) -> torch.Tensor:
    """One decode step's logits ``[V]`` (float32) on the unfused route
    (``decode_forward``) or the fused one (``_decode_forward_fused``), from
    copies of the caches."""
    from dynam3d_torch.models.vlm import phi3

    tmax = inp["mask"].shape[0]
    valid = inp["mask"].clone()[None]
    valid[0, pos] = True
    pp = torch.full((1, 1), pos, device=inp["e"].device)
    L, H, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if fused:
        cache = phi3.KVCache(inp["ck"].clone(), inp["cv"].clone())
        lg, _ = phi3._decode_forward_fused(params, cfg, inp["e"], pp, cache, pos, valid)
    else:
        cache = phi3.KVCache(inp["ck"].clone().view(L, 1, tmax, H, hd),
                             inp["cv"].clone().view(L, 1, tmax, H, hd))
        lg, _ = phi3.decode_forward(params, cfg, inp["e"], pp, cache, pos, valid[:, None, :])
    return lg[0, 0].float()


def parity(params, cfg, dev, tmax: int = 1024, pos: int = 830) -> Dict:
    """The fused and unfused routes' one-step logits from the same cache
    (the fused side only where its kernels take these weights)."""
    from dynam3d_torch.models.vlm import phi3

    inp = layer_inputs(cfg, dev, tmax, pos)
    lu = step_logits(params, cfg, inp, pos, fused=False)
    top = lu.topk(2).values
    out = {"unfused_argmax": int(lu.argmax()), "top1_gap_unfused": float(top[0] - top[1]),
           "scale": float(lu.abs().max()), "logits_unfused": lu.cpu().numpy()}
    if not phi3._fused_decode_eligible(params, cfg, 1):
        return dict(out, fused=False)
    lf = step_logits(params, cfg, inp, pos, fused=True)
    diff = (lf - lu).abs()
    return dict(out, fused=True, max_abs=float(diff.max()),
                max_rel=float(diff.max() / (lu.abs().max() + 1e-9)),
                argmax_same=bool(lf.argmax() == lu.argmax()), logits_fused=lf.cpu().numpy())


def run(params, cfg, dev, tmax: int = 1024, pos: int = 830, iters: int = 20) -> Dict:
    """Every part (on the card) and the parity, each printed as a JSON line."""
    line = card.card_line(dev)
    rows = []
    if dev.type == "cuda":
        rows = [card.emit(dict(tool="prof_decode_parts", **r), line)
                for r in measure(params, cfg, dev, tmax, pos, iters)]
    par = parity(params, cfg, dev, tmax, pos)
    card.emit({"tool": "prof_decode_parts", "part": "logits_parity",
               **{k: v for k, v in par.items() if not k.startswith("logits")}}, line)
    return {"parts": rows, "parity": par}


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tmax", type=int, default=1024)
    p.add_argument("--pos", type=int, default=830)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--layers", type=int, default=None, help="Phi-3-mini depth (default 32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    import dataclasses

    from dynam3d_torch.config import Phi3Config

    cfg = Phi3Config()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    cfg, params = card.int4_phi3(args.seed, dev, cfg)
    return run(params, cfg, dev, args.tmax, args.pos, args.iters)


if __name__ == "__main__":
    main()
