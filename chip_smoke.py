#!/usr/bin/env python3
"""Drive the PyTorch port (``dynam3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases build,matvec,ring
    python3 chip_smoke.py --phases build,nerf,knn,render,pretrain
    python3 chip_smoke.py --phases build,mlp,attn,matvec2d,routes,batched
    python3 chip_smoke.py --phases build,yolo,stream
    python3 chip_smoke.py --phases build,vln
    python3 chip_smoke.py --phases build,walk

Phases, each printed as it finishes:

1. the card's name and power limit (``nvidia-smi``);
2. ``build``: compile every CUDA kernel of the port at once (one ``nvcc``
   per source, into ``build/dynam3d_torch/``), print the registers and
   spills ``ptxas -v`` reports for each instantiation of kernels A, E, F,
   C, I, J, B, H and D (any spill in D fails), and every warning or
   performance note of any build;
3. ``matvec``: kernel A (``csrc/int4_matvec.cu``) against its plain PyTorch
   version at the main path's shapes (lm_head, qkv, o, gate_up + SwiGLU,
   down at 1, 8, 12 and 16 rows), with its time, the plain version's time,
   the time of a bf16 ``torch.matmul`` against the pre-dequantized weight
   (yardstick only) and the bandwidth bound;
4. ``ring``: kernel B (``csrc/decode_attn.cu``) and the whole decode layer
   (five launches) against the plain versions at Phi-3-mini widths,
   Tmax=1024 with ~900 valid rows, in the plain B=1, shared-cache k=8 and
   grouped B=4/g=2 modes, with SDPA (kernel B) and the layer as library
   calls on dequantized weights as yardsticks, and kernel B's work items,
   sequence splits and waves in each mode;
5. ``parity``: a small config (its tiny YOLOv8-seg at conf 0.1) through the
   port on the card and on the CPU (plain versions) with the same int4
   weights: identical ids per step;
6. ``episode``: the full-width serving slice — ``init_policy_params`` at the
   default config (YOLOv8-seg at FastSAM-x width, imgsz 576) on the card
   from a ``torch.Generator``, ``quantize_phi3(bits=4)``, then a 3-step
   ``EpisodeRunner.run`` on ``SyntheticRoomFeed`` — with every launch
   counter reset just before and read just after;
7. ``nerf``: kernel C (``csrc/nerf_mlp.cu``) against its plain version at
   N = 1152 (one novel view), 1152 + 37 (a ragged row tile) and 16 x 1152
   rows, D = 768, on the weights of ``init_render_params``: the clusters
   each N needs, those the card runs at once and the waves (N = 1152 must
   run in one), the time of the first view of a weight version (its bf16
   copies made anew), of a later view (copies cached) and of the first view
   on bf16 weights, with the same chain as six bf16 ``torch.matmul`` calls
   as its yardstick;
8. ``knn``: kernel D (``csrc/knn_topk.cu``) against its plain version at
   the renderer's stage-1 shape (72,144 ray samples, a 32,768-slot table of
   35 walk frames x 576 patches, k = 4), then on hard tables (dead slots
   interleaved, exact duplicate points in different pieces with ids equal
   to the plain version's, fewer than k live points over three or four
   pieces, none live, k = 1 and 8, ragged query counts), the live count
   its prologue wrote, its plan (queries a thread, tiles, grid, blocks per
   SM, pieces a tile), its bound over the live pairs and over every slot, with
   a chunked ``torch.matmul`` + ``torch.topk`` as its yardstick;
9. ``render``: one full-width ``render_view`` on that table under the
   default flags (banded k-NN, kernel C) and under
   ``DYNAM3D_DISABLE_BANDED_KNN=1 DYNAM3D_ENABLE_PALLAS_KNN=1`` (kernel D,
   kernel C): the same view within the stated tolerance, ms per view each;
10. ``pretrain``: the full-width 3DFF pretraining slice — ``fields``,
   ``render`` and CLIP-L/14-336 parameters from a ``torch.Generator`` (no
   LLaVA), ``PretrainRunner.run`` for 2 iterations on 16 unposed frames
   (default flags) and 2 on 4 posed frames (the k-NN flag configuration),
   with every launch counter reset just before and read just after, then
   one profiled iteration;
11. ``walk``: the hm3d walk of 3DFF pretraining at full width — ``fields``,
   ``render``, CLIP-L/14-336 with its text tower (which embeds the 16
   category names of the supervision), the ResNet-50 depth encoder
   (``input_size`` 256) and the TRM waypoint predictor from a
   ``torch.Generator``; ``WalkDriver`` (nv = 4, ``pretrain_traj_len``
   steps, waypoint augmentation, teacher share ``sample_ratio`` / 2) on a
   12-view ``SyntheticRoomFeed`` (336² RGB, 256² depth): 2 episodes under
   the default flags through ``PretrainRunner.run`` with a
   ``MetricsLogger`` and a checkpoint per iteration, 1 under the k-NN
   gates, each window's launch counters reset just before and read just
   after (kernel C in both, D under the gates, no plain version); finite
   metrics, 1..5 steps, moved parameters, the checkpoint loaded back
   equal; ms per episode and per step, peak memory, one profiled episode;
12. ``matvec2d``: kernel E (``csrc/int4_matvec2d.cu``) against its plain
   version and against kernel A at the lm_head and qkv shapes, 1, 8, 12 and
   16 rows, with its work items (column tiles x scale groups) and the
   blocks an SM holds;
13. ``mlp``: kernels F and G (``csrc/int4_mlp.cu``) against their plain
   versions at Phi-3-mini widths (D=3072, I=8192), 1, 8, 12 and 16 rows,
   with two bf16 ``torch.matmul`` on pre-dequantized weights plus ``silu``
   as the yardstick, and F's cooperative grid;
14. ``attn``: kernel H (``csrc/decode_attn_layer.cu``) against its plain
   version at Phi-3-mini widths, Tmax=1024, ~870 valid rows with holes, with
   dequantized bf16 matmuls plus ``scaled_dot_product_attention`` as the
   yardstick, and its cooperative grid and sequence splits;
15. ``routes``: the small config on the card and on the CPU through every
   decode route of this slice (B=1 split, B=1 unfused speculation with and
   without ``DYNAM3D_INT4_GRID2D``, B=3 grouped speculation, B=12 unfused):
   identical ids per step and row;
16. ``batched``: full-width 2-step episodes on one set of quantized
   parameters: 12 feeds at the default flags (kernels F and A), 1 feed on
   the split route (H and G), 1 feed unfused under ``DYNAM3D_INT4_GRID2D``
   (E and F), 4 feeds (grouped speculation, kernel B), each with the launch
   counters reset just before and read just after and no plain version on
   the path, then one profiled 12-feed step;
17. ``yolo``: one full-width ``segment_views`` (FastSAM-x, imgsz 576) of a
   ``SyntheticRoomFeed`` view on the card and, with the same weights, on the
   CPU: ``forward`` within the stated tolerance, the same NMS picks and ids,
   ms per view, and the launches of the NMS loop;
18. ``stream``: kernels I and J (``csrc/int4_stream.cu``) against their plain
   versions at the int4 tools' shapes (4 weights of 3072 x 16384), every
   ring variant of I and every body of J, each with its work items, blocks
   per SM, dynamic shared memory and share of the bytes bound, then both
   tools' sweeps (``dynam3d_torch.tools.bench_int4_stream`` /
   ``bench_int4_unpack``) with the launch counters reset just before and
   read just after, the bytes bound and a bf16 ``torch.matmul`` on the
   dequantized weights as the yardstick;
19. ``vln``: the VLN second stage at full width — policy parameters with
   Phi-3-mini in bf16 at the default config, the ResNet-50 depth encoder
   (``input_size`` 256) and the TRM waypoint predictor from a
   ``torch.Generator``; ``VLNTrainer.run`` (``cfg.train``: one iteration,
   saved) training one episode of 3 steps on a 12-view
   ``SyntheticRoomFeed`` (336² RGB, 256² depth), printing per step the
   loss, grad norm, skip flag, ms (synchronized), peak memory and the
   predictor's candidates, the ``save_checkpoint`` time, and how many
   tensors moved in the five projector trees and in Phi-3; a second
   trainer's requeued ``run`` resumes from that checkpoint (identical
   tensors, no episode left); one more IL step profiled on its own (device
   busy time over that step's wall time); then ``quantize_phi3(bits=4)``
   of the trained tree and ``evaluate`` (2 feeds of 3 steps,
   ``ignore_stop``) and ``inference`` (r2r and rxr) with the launch
   counters reset just before and read just after (kernels A and B, no
   plain version); then one ``VLNTrainer`` step of a small config on the
   card and on the CPU with the same weights: loss, updated trainable
   tensors, waypoint heatmaps and candidates within the stated tolerances;
20. ``cli``: the port as a user starts it, at the default ``Dynam3DConfig()``
   with random weights, in a temporary working directory:
   ``dynam3d_torch.run.main`` for ``eval`` (8 episodes of at most 3 steps:
   6 ``SyntheticRoomFeed`` rooms and 2 ``FloorplanFeed`` apartments at 336²
   RGB and 256² depth), ``inference`` (4 episodes), ``train`` with the
   ``Dynam3D`` trainer (1 iteration of at most 3 steps, saved) and with
   ``SS-ETP`` (2 pretraining iterations, kernel C on every render), then
   ``dynam3d_torch.tools.eval_soak`` over 2 full 50-step episodes (one
   floorplan, one room) on int4 weights with speculative decode (kernels A
   and B); each step's files checked, its wall time and peak memory
   printed, the launch counters reset just before each step and read just
   after (A and B in the soak, C in SS-ETP, no plain version anywhere).

Any failure exits non-zero.  The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time

PHASES = ("build", "matvec", "ring", "parity", "episode", "nerf", "knn", "render", "pretrain",
          "walk", "matvec2d", "mlp", "attn", "routes", "batched", "yolo", "stream", "vln",
          "cli")

# the dense bf16 tensor-core peak and the float32 peak outside the tensor
# cores (H100 SXM); memory rates are dynam3d_torch.device.MEM_RATES
BF16_PEAK = 989e12
FP32_PEAK = 67e12
KNN_FLAG_ENV = {"DYNAM3D_DISABLE_BANDED_KNN": "1", "DYNAM3D_ENABLE_PALLAS_KNN": "1"}


def log(msg: str) -> None:
    print(msg, flush=True)


def mem_rate(name: str) -> float:
    from dynam3d_torch.device import mem_rate as rate

    return rate(name)


def bound(nbytes: float, ops: float, name: str, peak: float = BF16_PEAK):
    """Least time in ms for the work, and what bounds it."""
    tb, to = nbytes / mem_rate(name), ops / peak
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


class Timer:
    """Mean device time of one call with the L2 cache flushed before it (the
    decode loop finds its weights cold).

    The flush reads a 96 MB buffer (a sum whose result is dropped): a write
    would leave dirty lines that the timed call's own reads must first write
    back.  CUDA events span ``iters`` (flush, call) pairs, minus the same
    window of flushes alone.  A GPU sleep enqueued ahead of each window holds
    the card while the host enqueues the whole window, so the wrappers' host
    time does not open gaps on the device that would count as kernel time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.zeros(24 * 2**20, dtype=torch.float32, device="cuda")
        self.flush_out = torch.zeros((), dtype=torch.float32, device="cuda")
        self.flush()   # the reduction's first launch loads its module: not in a window
        torch.cuda.synchronize()

    def flush(self) -> None:
        self.torch.sum(self.flush_buf, 0, out=self.flush_out)

    def _window(self, fn, iters: int, sleep_cycles: int) -> float:
        torch = self.torch
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(iters):
            self.flush()
            if fn is not None:
                fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        host_s = 0.0
        for _ in range(warmup):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host_s = time.perf_counter() - t0     # enqueue time of the last warm call
        torch.cuda.synchronize()
        # cycles at ~2 GHz covering twice the window's enqueue time
        sleep_cycles = int(2 * iters * (host_s + 20e-6) * 2e9)
        both = self._window(fn, iters, sleep_cycles)
        flush = self._window(None, iters, sleep_cycles)
        return max(0.0, (both - flush) / iters)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_build(ctx):
    from dynam3d_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    log(f"[build] kernels {list(kernels.SOURCES)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in ("int4_matvec", "int4_matvec2d", "int4_mlp", "nerf_mlp", "int4_stream",
                 "decode_attn", "decode_attn_layer", "knn_topk"):
        for fn, regs, st, ld in kernels.ptxas_summary(name):
            log(f"[build] ptxas {name}.cu {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
            if name == "knn_topk" and (st or ld):
                raise AssertionError(f"knn_topk.cu {fn} spills")
    for name in kernels.SOURCES:
        for line in kernels.build_warnings(name):
            log(f"[build] {name}.cu: {line}")


def _dequant_bf16(torch, w):
    from dynam3d_torch.ops.int4 import unpack_nibbles

    lo, hi = unpack_nibbles(w.q4)
    g = w.dp // w.dblk

    def half(q, s):
        return (q.to(torch.float32).view(g, w.dblk, w.n2) * s[:, None, :]).view(w.dp, w.n2)

    return torch.cat([half(lo, w.s_lo), half(hi, w.s_hi)], 1)[: w.d, : w.n].to(torch.bfloat16)


def phase_matvec(ctx):
    """Kernel A vs its plain version at the main path's shapes."""
    torch = ctx["torch"]
    from dynam3d_torch.ops.int4 import int4_matvec_cuda, int4_matvec_plain, pack_int4

    gen = ctx["gen"]
    dev = "cuda"
    timer = ctx["timer"]
    shapes = [  # name, d, n, x dtype, ln prologue, epilogue, residual dtype, out dtype
        ("lm_head", 3072, 32064, torch.bfloat16, False, "store", None, torch.float32),
        ("qkv", 3072, 9216, torch.bfloat16, True, "store", None, torch.float32),
        ("o", 3072, 3072, torch.bfloat16, False, "residual", torch.bfloat16, torch.float32),
        ("gate_up", 3072, 16384, torch.float32, True, "swiglu", None, torch.bfloat16),
        ("down", 8192, 3072, torch.bfloat16, False, "residual", torch.float32, torch.bfloat16),
    ]
    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    max_err = 0.0
    rows_out = []
    for name, d, n, xdt, ln, epi, rdt, odt in shapes:
        w = pack_int4(torch.randn(d, n, generator=gen, device=dev) * 0.02)
        wd = _dequant_bf16(torch, w)
        ln_w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)) if ln else None
        for rows in (1, 8, 12, 16):
            x = torch.randn(rows, d, generator=gen, device=dev).to(xdt)
            res = (torch.randn(rows, n, generator=gen, device=dev).to(rdt)
                   if rdt is not None else None)
            kw = dict(ln_w=ln_w, eps=1e-5, residual=res, epilogue=epi, out_dtype=odt)
            yk = int4_matvec_cuda(x, w, **kw)
            yp = int4_matvec_plain(x, w, **kw)
            torch.cuda.synchronize()
            ref = yp.float()
            err = (yk.float() - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            # f32 outputs: same exact products, another summation order;
            # bf16 outputs: one bf16 rounding step apart at most
            tol = (1e-3 if odt == torch.float32 else 1.6e-2) * scale
            if not (err <= tol and torch.isfinite(yk.float()).all()):
                raise AssertionError(f"int4_matvec {name} rows={rows}: err {err} > {tol}")
            max_err = max(max_err, err)
            ms = timer(lambda: int4_matvec_cuda(x, w, **kw))
            plain_ms = timer(lambda: int4_matvec_plain(x, w, **kw), iters=3, warmup=1)
            xb = x.to(torch.bfloat16)
            lib_ms = timer(lambda: torch.matmul(xb, wd))
            nout = w.n2 if epi == "swiglu" else w.n
            nbytes = (w.q4.numel() + 8 * w.s_lo.numel() + x.numel() * x.element_size()
                      + rows * nout * (4 if odt == torch.float32 else 2)
                      + (res.numel() * res.element_size() if res is not None else 0))
            b_ms, b_by = bound(nbytes, 2.0 * rows * d * n, ctx["card"])
            row = dict(shape=name, rows=rows, d=d, n=n, max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes)
            rows_out.append(row)
            log(f"[matvec] {json.dumps(row)}")
            if rows == 8 and name != "lm_head":
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    layer[key] += row[key]
                layer["bytes"] += nbytes
        del wd
    ctx["matvec"] = dict(layer, max_abs_err=max_err, rows=rows_out)


def _ring_case(torch, gen, weights, B, group, pos_rows, holes=(100, 120)):
    """Inputs of one decode layer at Phi-3-mini widths."""
    D, hd, tmax = 3072, 96, 1024
    n_cache = B // group
    ck = torch.randn(1, n_cache, tmax, D, generator=gen, device="cuda").to(torch.bfloat16)
    cv = torch.randn(1, n_cache, tmax, D, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(B, 1, D, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.arange(tmax, device="cuda")
    mask = torch.stack([(t < p) & ~((t >= holes[0]) & (t < holes[1])) for p in pos_rows])
    freqs = 10000.0 ** (-torch.arange(0, hd // 2, device="cuda", dtype=torch.float32) / (hd // 2))
    rope_pos = torch.tensor([p - 20 + (i % group) for i, p in enumerate(pos_rows)],
                            device="cuda", dtype=torch.float32)
    ang = rope_pos[:, None] * freqs
    return dict(x=x, cache_k=ck, cache_v=cv, mask=mask, cos=torch.cos(ang),
                sin=torch.sin(ang), pos=list(pos_rows), **weights)


def phase_ring(ctx):
    """Kernel B and the five-launch decode layer vs the plain versions."""
    torch = ctx["torch"]
    from dynam3d_torch.ops.decode import (
        attn_plan, decode_attn_cuda, decode_attn_plain, decode_layer_ring_cuda,
        decode_layer_ring_plain, scan_length,
    )
    from dynam3d_torch.ops.int4 import int4_matvec_plain, pack_int4

    gen, timer, dev = ctx["gen"], ctx["timer"], "cuda"
    D, I, H, hd = 3072, 8192, 32, 96
    weights = {
        "qkv": pack_int4(torch.randn(D, 3 * D, generator=gen, device=dev) * 0.02),
        "o": pack_int4(torch.randn(D, D, generator=gen, device=dev) * 0.02),
        "gate_up": pack_int4(torch.randn(D, 2 * I, generator=gen, device=dev) * 0.02),
        "down": pack_int4(torch.randn(I, D, generator=gen, device=dev) * 0.02),
        "ln1_w": 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev),
        "ln2_w": 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev),
    }
    modes = [("plain", 1, dict(), 1, [900]),
             ("shared_cache", 8, dict(shared_cache=True), 8, [900] * 8),
             ("group_size", 4, dict(group_size=2), 2, [900, 900, 905, 905])]
    dense = {k: _dequant_bf16(torch, weights[k]) for k in ("qkv", "o", "gate_up", "down")}
    max_err, attn_entry, out = 0.0, None, []
    for mode, B, kw, group, pos_rows in modes:
        c = _ring_case(torch, gen, weights, B, group, pos_rows)
        args = (c["x"], c["ln1_w"], c["qkv"], c["o"], c["ln2_w"], c["gate_up"],
                c["down"], c["cache_k"], c["cache_v"], 0, c["pos"], c["mask"],
                c["cos"], c["sin"])
        lk = decode_layer_ring_cuda(*args, eps=1e-5, heads=H, hd=hd, **kw)
        lp = decode_layer_ring_plain(*args, eps=1e-5, heads=H, hd=hd, **kw)
        torch.cuda.synchronize()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(lk, lp)]
        # bf16 outputs of a chain of f32 sums in another order: at most a
        # couple of bf16 rounding steps apart
        tols = [3e-2 * max(1.0, b.float().abs().max().item()) for b in lp]
        for e, tol, nm in zip(errs, tols, ("x_out", "k_new", "v_new")):
            if not e <= tol:
                raise AssertionError(f"decode_layer_ring {mode} {nm}: err {e} > {tol}")
        layer_ms = timer(lambda: decode_layer_ring_cuda(*args, eps=1e-5, heads=H, hd=hd, **kw))
        layer_plain_ms = timer(
            lambda: decode_layer_ring_plain(*args, eps=1e-5, heads=H, hd=hd, **kw),
            iters=3, warmup=1)
        # kernel B alone, on the qkv matvec's output
        y = int4_matvec_plain(c["x"].view(B, D), c["qkv"], ln_w=c["ln1_w"], eps=1e-5)
        t_scan = scan_length(c["pos"], 1024)
        aargs = (y, c["cos"], c["sin"], c["cache_k"], c["cache_v"], 0, c["mask"], t_scan, group)
        ak = decode_attn_cuda(*aargs, heads=H, hd=hd)
        ap = decode_attn_plain(*aargs, heads=H, hd=hd)
        torch.cuda.synchronize()
        a_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(ak, ap))
        # bf16 outputs of f32 softmax sums in another order: one bf16 step
        a_tol = 1.6e-2 * max(max(1.0, b.float().abs().max().item()) for b in ap)
        if not a_err <= a_tol:
            raise AssertionError(f"decode_attn {mode}: err {a_err} > {a_tol}")
        a_ms = timer(lambda: decode_attn_cuda(*aargs, heads=H, hd=hd))
        a_plain_ms = timer(lambda: decode_attn_plain(*aargs, heads=H, hd=hd), iters=3, warmup=1)
        # yardstick: SDPA over the same cache rows and mask (no RoPE, no fold)
        q = y[:, :D].view(B, H, 1, hd).to(torch.bfloat16)
        kc = c["cache_k"][0, :, :t_scan].view(B // group, t_scan, H, hd).transpose(1, 2)
        vc = c["cache_v"][0, :, :t_scan].view(B // group, t_scan, H, hd).transpose(1, 2)
        kc = kc.repeat_interleave(group, 0)
        vc = vc.repeat_interleave(group, 0)
        am = c["mask"][:, None, None, :t_scan]
        lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(q, kc, vc, attn_mask=am))
        layer_lib_ms = timer(lambda: _library_layer(torch, ctx, c, dense, q, kc, vc, am))
        valid_rows = int(c["mask"][::group, :t_scan].sum().item())
        a_bytes = (valid_rows * D * 2 * 2 + y.numel() * 4 + 3 * B * D * 2
                   + c["mask"].numel() + 2 * c["cos"].numel() * 4)
        a_ops = 4.0 * B * (valid_rows // max(1, B // group)) * D
        a_b_ms, a_b_by = bound(a_bytes, a_ops, ctx["card"])
        w_bytes = sum(weights[k].q4.numel() + 8 * weights[k].s_lo.numel()
                      for k in ("qkv", "o", "gate_up", "down"))
        l_b_ms, l_b_by = bound(w_bytes + a_bytes, a_ops + 2.0 * B * (D * 3 * D + D * D + D * 2 * I + I * D),
                               ctx["card"])
        pl = attn_plan(y.device, hd, H, B // group, t_scan)
        row = dict(mode=mode, B=B, group=group, t_scan=t_scan, valid_rows=valid_rows,
                   layer_err=max(errs), layer_tol=min(tols), layer_ms=layer_ms,
                   layer_plain_ms=layer_plain_ms, layer_library_ms=layer_lib_ms,
                   layer_bound_ms=l_b_ms, layer_bytes=w_bytes + a_bytes, attn_err=a_err,
                   attn_tol=a_tol, attn_ms=a_ms, attn_plain_ms=a_plain_ms,
                   attn_library_ms=lib_ms, attn_bound_ms=a_b_ms, attn_bound_by=a_b_by,
                   attn_bytes=a_bytes, items=pl.items, splits=pl.nsplit, tiles_per_split=pl.tps,
                   blocks_per_sm=pl.blocks_per_sm, waves=pl.waves)
        out.append(row)
        log(f"[ring] {json.dumps(row)}")
        max_err = max(max_err, a_err)
        if mode == "shared_cache":
            attn_entry = dict(ms=a_ms, plain_ms=a_plain_ms, library_ms=lib_ms,
                              bound_ms=a_b_ms, bound_by=a_b_by)
    ctx["ring"] = dict(attn_entry, max_abs_err=max_err, rows=out)


def _rms_bf16(torch, x, w):
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5) * w).to(torch.bfloat16)


def _library_layer(torch, ctx, c, dense, q, kc, vc, am):
    """A decode layer as library calls on pre-dequantized bf16 weights
    (yardstick only): rmsnorm, qkv matmul, SDPA over the cache rows, o
    matmul + residual, rmsnorm, gate_up matmul, SwiGLU, down matmul +
    residual.  RoPE and the in-flight rows are left out."""
    B, D = c["x"].shape[0], c["x"].shape[-1]
    x = c["x"].view(B, D)
    y = _rms_bf16(torch, x, c["ln1_w"]) @ dense["qkv"]
    a = torch.nn.functional.scaled_dot_product_attention(q, kc, vc, attn_mask=am)
    x1 = x + a.reshape(B, D).to(torch.bfloat16) @ dense["o"]
    gu = _rms_bf16(torch, x1, c["ln2_w"]) @ dense["gate_up"]
    g, u = gu.chunk(2, dim=-1)
    return x1 + (torch.nn.functional.silu(g) * u) @ dense["down"], y


def _tiny_config():
    """A few-layer, narrow config (the CPU tests' slice config)."""
    from dynam3d_torch.config import (
        CLIPConfig, DepthEncoderConfig, Dynam3DConfig, FieldsConfig, LLaVAConfig, Phi3Config,
        SegmenterConfig, WaypointConfig,
    )

    return Dynam3DConfig(
        fields=FieldsConfig(input_height=4, input_width=4, fts_dim=64, patch_capacity=256,
                            instance_capacity=64, zone_capacity=32, max_segments=8,
                            max_members=32, max_zone_members=16, encoder_dtype="f32"),
        clip=CLIPConfig(image_size=56, patch_size=14, vision_width=64, vision_layers=2,
                        vision_heads=2, embed_dim=64, compute_dtype="f32"),
        llava=LLaVAConfig(
            phi3=Phi3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                            num_layers=2, num_heads=2, num_kv_heads=2, head_dim=32,
                            pad_token_id=260, end_token_id=257),
            projector_hidden=64, prefill_bucket=64, max_new_tokens=8),
        # the CPU tests' tiny YOLOv8-seg, at a conf that keeps several masks
        segmenter=SegmenterConfig(provider="yolov8", imgsz=32, width_mult=0.125,
                                  depth_mult=0.34, num_protos=8, max_masks=8, conf=0.1),
        depth=DepthEncoderConfig(input_size=64, output_size=32, base_planes=8, ngroups=4),
        waypoint=WaypointConfig(hidden_dim=64, trm_layers=1, num_attention_heads=4),
    )


def phase_parity(ctx):
    """A small input through the port twice — on the card (kernels) and on
    the CPU (plain versions, which the CPU tests hold against the JAX
    package) — with the same int4 weights: the generated ids of a 3-step
    episode must be identical."""
    torch = ctx["torch"]
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    cfg, params = _tiny_int4_params(torch)
    gens = {}
    for dev in ("cpu", "cuda"):
        p = _to_device(torch, params, dev)
        runner = EpisodeRunner(p, cfg, device=dev)
        runner.run([SyntheticRoomFeed(rgb_size=56, depth_size=32, seed=3)], max_steps=3,
                   ignore_stop=True)
        gens[dev] = [s["gen"] for s in runner.step_log]
    log(f"[parity] ids per step cpu={gens['cpu']} cuda={gens['cuda']}")
    if gens["cpu"] != gens["cuda"]:
        raise AssertionError("generated ids differ between the card and the plain versions")
    if "yolo" not in params:
        raise AssertionError("the tiny config did not build its YOLOv8-seg segmenter")


def _to_device(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(torch, v, dev) for v in tree]
    return tree.to(dev)          # tensors and Int4Weight


def phase_episode(ctx):
    """The full-width serving slice, with the launch counters reset just
    before the episode and read just after."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    cfg, params = _serving_params(ctx)
    if cfg.segmenter.provider != "yolov8" or "yolo" not in params:
        raise AssertionError("the episode does not run the default YOLOv8-seg segmenter")
    runner = EpisodeRunner(params, cfg, device="cuda")
    feed = SyntheticRoomFeed(rgb_size=336, depth_size=256, views=1, seed=0)
    # one warm-up episode step outside the counted window is not needed:
    # the counters below cover exactly this run
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    res = runner.run([feed], max_steps=3, ignore_stop=True)
    torch.cuda.synchronize()
    counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
    log(f"[episode] launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
    for name in ("int4_matvec", "decode_attn"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if any(plain.values()):
        raise AssertionError(f"plain kernel versions ran on the main path: {plain}")
    if res[0]["steps"] != 3 or not math.isfinite(res[0]["distance_to_goal"]):
        raise AssertionError(f"episode result {res}")
    for st in runner.step_log:
        gen_ids = st["gen"]
        if len(gen_ids) != cfg.llava.max_new_tokens:
            raise AssertionError(f"generated ids of wrong length: {gen_ids}")
        log(f"[episode] step {json.dumps({k: v for k, v in st.items() if k != 'gen'})}")
    if not runner.step_log[-1]["mm_finite"]:
        raise AssertionError("non-finite multimodal tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[episode] steps={res[0]['steps']} peak_mem_gib={peak:.2f}")
    ctx["launches"] = counts
    steady = [st["ms"] for st in runner.step_log[1:]]
    _profile_step(torch, runner, sum(steady) / len(steady),
                  [SyntheticRoomFeed(rgb_size=336, depth_size=256, views=1, seed=1)], "b1")


def _profile_step(torch, runner, steady_ms, feeds, label):
    """One more 1-step episode on ``feeds`` under ``torch.profiler`` (outside
    the counted window): device time by kernel, and the device's busy and
    idle share of ``steady_ms``, the un-profiled step time (the profiler's
    own overhead inflates the profiled wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynam3d_torch.ops.kernels import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.run(feeds, max_steps=1, ignore_stop=True)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels_ = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                      key=lambda r: -r[1])
    if not kernels_:
        log("[profile] device time not measured (the profiler saw no kernels)")
        return
    busy_ms = sum(r[1] for r in kernels_) / 1e3
    log(f"[profile] {label} device_busy_ms={busy_ms:.1f} steady_step_ms={steady_ms:.1f} "
        f"idle_share={max(0.0, 1 - busy_ms / steady_ms):.3f} kernels={len(kernels_)}")
    # kernel symbols: <name>_kernel (kernels F and G share int4_mlp_kernel)
    names = [k for k in KERNELS if k != "int4_mlp_block"]
    groups = dict({k: 0.0 for k in names}, int8_gemm=0.0, other=0.0)
    for key, us, _ in kernels_:
        g = next((k for k in names if f"{k}_kernel" in key),
                 "int8_gemm" if "gemm_s8" in key else "other")
        groups[g] += us / 1e3
    log(f"[profile] device_ms_by_group {json.dumps(groups)}")
    for key, us, n in kernels_[:15]:
        log(f"[profile] {us / 1e3:9.3f} ms  x{n:<6d} {key[:100]}")


def _check(name, got, ref, tol):
    """Max abs difference of a kernel's output from its plain version's;
    raises above ``tol`` or on a non-finite output."""
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= tol and bool(got.float().isfinite().all())):
        raise AssertionError(f"{name}: err {err} > {tol}")
    return err


def _weight_bytes(*ws) -> int:
    return sum(w.q4.numel() + 4 * (w.s_lo.numel() + w.s_hi.numel()) for w in ws)


def phase_matvec2d(ctx):
    """Kernel E vs its plain version and vs kernel A at the lm_head and qkv
    shapes, at 1, 8, 12 and 16 rows."""
    torch = ctx["torch"]
    from dynam3d_torch.ops.int4 import (
        int4_matvec2d_cuda, int4_matvec2d_plain, int4_matvec_cuda, pack_int4,
    )

    from dynam3d_torch.ops import kernels
    from dynam3d_torch.ops.int4 import _bind_matvec2d

    gen, timer = ctx["gen"], ctx["timer"]
    lib = kernels.library("int4_matvec2d")
    _bind_matvec2d(lib)
    rows_out, entry = [], None
    for name, d, n in (("lm_head", 3072, 32064), ("qkv", 3072, 9216)):
        w = pack_int4(torch.randn(d, n, generator=gen, device="cuda") * 0.02)
        wd = _dequant_bf16(torch, w)
        # one work item per (128-column tile, scale group), on the mma body
        items = lib.int4_matvec2d_items(w.n2, w.dp, w.dblk)
        for rows in (1, 8, 12, 16):
            per_sm = ctypes.c_int(0)
            kernels.check(lib.int4_matvec2d_blocks_per_sm(rows, ctypes.byref(per_sm)),
                          "int4_matvec2d")
            x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
            yk = int4_matvec2d_cuda(x, w)
            yp = int4_matvec2d_plain(x, w)
            ya = int4_matvec_cuda(x, w)
            torch.cuda.synchronize()
            # f32 outputs of the same exact products summed in another order
            tol = 1e-3 * max(1.0, yp.abs().max().item())
            err = _check(f"int4_matvec2d {name} rows={rows}", yk, yp, tol)
            err_a = _check(f"int4_matvec2d vs kernel A {name} rows={rows}", yk, ya, tol)
            ms = timer(lambda: int4_matvec2d_cuda(x, w))
            a_ms = timer(lambda: int4_matvec_cuda(x, w))
            plain_ms = timer(lambda: int4_matvec2d_plain(x, w), iters=3, warmup=1)
            lib_ms = timer(lambda: torch.matmul(x, wd))
            nbytes = _weight_bytes(w) + x.numel() * 2 + rows * n * 4
            b_ms, b_by = bound(nbytes, 2.0 * rows * d * n, ctx["card"])
            row = dict(shape=name, rows=rows, d=d, n=n, items=items, blocks_per_sm=per_sm.value,
                       max_abs_err=err, err_vs_kernel_a=err_a, tol=tol, ms=ms, kernel_a_ms=a_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       bytes=nbytes)
            rows_out.append(row)
            log(f"[matvec2d] {json.dumps(row)}")
            if name == "qkv" and rows == 8:
                entry = dict(row)
        del wd
    ctx["matvec2d"] = dict(entry, max_abs_err=max(r["max_abs_err"] for r in rows_out),
                           rows=rows_out)


def phase_mlp(ctx):
    """Kernels F and G vs their plain versions at Phi-3-mini widths, at 1, 8,
    12 and 16 rows, with two bf16 matmuls on pre-dequantized weights plus
    silu as the yardstick."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.ops.int4 import (
        int4_mlp_block_cuda, int4_mlp_block_plain, int4_mlp_cuda, int4_mlp_plain, pack_int4,
        plan,
    )

    gen, timer = ctx["gen"], ctx["timer"]
    D, I = 3072, 8192
    gu = pack_int4(torch.randn(D, 2 * I, generator=gen, device="cuda") * 0.02)
    dn = pack_int4(torch.randn(I, D, generator=gen, device="cuda") * 0.02)
    ln_w = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    gud, dnd = _dequant_bf16(torch, gu), _dequant_bf16(torch, dn)

    def library(x, block):
        h = _rms_bf16(torch, x, ln_w) if block else x
        g, u = (h @ gud).chunk(2, dim=-1)
        y = (torch.nn.functional.silu(g) * u) @ dnd
        return x + y if block else y

    rows_out, entries = [], {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (1, 8, 12, 16):
        x = torch.randn(rows, D, generator=gen, device="cuda").to(torch.bfloat16)
        # F's cooperative launch plan: grid, gate_up and down K slices
        grid, ks1, ks2 = plan(kernels.library("int4_mlp"), "int4_mlp_plan", x.device, rows,
                              gu.dp, gu.n2, dn.dp, dn.n2, gu.dblk)
        log(f"[mlp] rows={rows} cooperative grid {grid} blocks ({grid / sms:g} per SM on {sms} "
            f"SMs), K slices {ks1} / {ks2}")
        for name, block in (("int4_mlp", False), ("int4_mlp_block", True)):
            args = (x, ln_w, gu, dn, 1e-5) if block else (x, gu, dn)
            cuda_fn, plain_fn = ((int4_mlp_block_cuda, int4_mlp_block_plain) if block
                                 else (int4_mlp_cuda, int4_mlp_plain))

            def kern():
                return cuda_fn(*args, out_dtype=torch.bfloat16)

            def plain():
                return plain_fn(*args, out_dtype=torch.bfloat16)
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            err = _check(f"{name} rows={rows}", yk, yp, _bf16_tol(yp))
            ms = timer(kern)
            plain_ms = timer(plain, iters=3, warmup=1)
            lib_ms = timer(lambda: library(x, block))
            nbytes = (_weight_bytes(gu, dn) + x.numel() * 2 + rows * D * 2
                      + (ln_w.numel() * 4 if block else 0))
            b_ms, b_by = bound(nbytes, 2.0 * rows * (D * 2 * I + I * D), ctx["card"])
            row = dict(kernel=name, rows=rows, D=D, I=I, max_abs_err=err, tol=_bf16_tol(yp),
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes)
            rows_out.append(row)
            log(f"[mlp] {json.dumps(row)}")
            # the rows each kernel takes on the main path: F at the B=12
            # batch, G at B=1 on the split route
            if (name, rows) in (("int4_mlp", 12), ("int4_mlp_block", 1)):
                entries[name] = dict(row)
    for name in entries:
        entries[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows_out
                                           if r["kernel"] == name)
    ctx["mlp"] = entries


def phase_attn(ctx):
    """Kernel H vs its plain version at Phi-3-mini widths, Tmax=1024, write
    slot 900 with holes, with dequantized bf16 matmuls plus SDPA as the
    yardstick."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.ops.decode import (
        attn_splits, decode_attn_layer_cuda, decode_attn_layer_plain, scan_length,
    )
    from dynam3d_torch.ops.int4 import pack_int4, plan

    gen, timer = ctx["gen"], ctx["timer"]
    D, H, hd, tmax, pos, li = 3072, 32, 96, 1024, 900, 1
    qkv = pack_int4(torch.randn(D, 3 * D, generator=gen, device="cuda") * 0.02)
    o = pack_int4(torch.randn(D, D, generator=gen, device="cuda") * 0.02)
    ln_w = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    x = torch.randn(1, 1, D, generator=gen, device="cuda").to(torch.bfloat16)
    ck = torch.randn(2, 1, tmax, D, generator=gen, device="cuda").to(torch.bfloat16)
    cv = torch.randn(2, 1, tmax, D, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.arange(tmax, device="cuda")
    mask = (t < pos) & ~((t >= 100) & (t < 120)) & ~((t >= 600) & (t < 611))
    freqs = 10000.0 ** (-torch.arange(0, hd // 2, device="cuda", dtype=torch.float32) / (hd // 2))
    ang = (pos - 31) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    args = (x, ln_w, qkv, o, ck, cv, li, pos, mask, cos, sin)
    kw = dict(eps=1e-5, heads=H, hd=hd)
    hk = decode_attn_layer_cuda(*args, **kw)
    hp = decode_attn_layer_plain(*args, **kw)
    torch.cuda.synchronize()
    # bf16 outputs of a chain of f32 sums in another order: at most a couple
    # of bf16 rounding steps apart
    err = max(_check(f"decode_attn_layer {nm}", a, b, 3e-2 * max(1.0, b.float().abs().max().item()))
              for nm, a, b in zip(("x_out", "k_new", "v_new"), hk, hp))
    ms = timer(lambda: decode_attn_layer_cuda(*args, **kw))
    plain_ms = timer(lambda: decode_attn_layer_plain(*args, **kw), iters=3, warmup=1)
    qd, od = _dequant_bf16(torch, qkv), _dequant_bf16(torch, o)
    t_scan = scan_length(pos, tmax)
    kc = ck[li, :, :t_scan].view(1, t_scan, H, hd).transpose(1, 2)
    vc = cv[li, :, :t_scan].view(1, t_scan, H, hd).transpose(1, 2)
    am = mask[None, None, None, :t_scan]

    def library():
        y = _rms_bf16(torch, x.view(1, D), ln_w) @ qd
        q = y[:, :D].view(1, H, 1, hd)
        a = torch.nn.functional.scaled_dot_product_attention(q, kc, vc, attn_mask=am)
        return x.view(1, D) + a.reshape(1, D) @ od

    lib_ms = timer(library)
    valid_rows = int(mask.sum().item())
    nbytes = (_weight_bytes(qkv, o) + 2 * valid_rows * D * 2 + ln_w.numel() * 4
              + x.numel() * 2 + mask.numel() + 2 * cos.numel() * 4 + 3 * D * 2)
    ops = 2.0 * (D * 3 * D + D * D) + 4.0 * valid_rows * D
    b_ms, b_by = bound(nbytes, ops, ctx["card"])
    grid, ks1, ks3 = plan(kernels.library("decode_attn_layer"), "decode_attn_layer_plan",
                          x.device, hd, qkv.dp, qkv.n2, o.dp, o.n2, qkv.dblk)
    nsplit, tps = attn_splits(grid, H, t_scan)
    row = dict(D=D, heads=H, hd=hd, tmax=tmax, pos=pos, valid_rows=valid_rows, max_abs_err=err,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, grid=grid, ks1=ks1, ks3=ks3, splits=nsplit, tiles_per_split=tps,
               items=H * nsplit)
    log(f"[attn] {json.dumps(row)}")
    ctx["attn"] = row


# route name, feeds, decode flags, kernels that must launch on the card
ROUTES = [
    ("split", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_SPEC_DECODE": "0"},
     ("decode_attn_layer", "int4_mlp_block")),
    ("unfused_spec", 1, {"DYNAM3D_FUSED_RING": "0"}, ("int4_mlp", "int4_matvec")),
    ("unfused_spec_grid2d", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_INT4_GRID2D": "1"},
     ("int4_mlp", "int4_matvec2d")),
    ("grouped_spec", 3, {}, ("decode_attn", "int4_matvec")),
    ("unfused_b12", 12, {}, ("int4_mlp", "int4_matvec")),
]


def _tiny_int4_params(torch):
    from dynam3d_torch.models import policy
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3
    from dynam3d_torch.ops.int4 import pack_int4

    cfg = _tiny_config()
    # seed 8: on the CPU every greedy step of the parity episode and the
    # routes keeps its top two logits >= 0.01 apart (the tiny random model's
    # logits are nearly flat, and card and CPU sum in other orders)
    params = policy.init_policy_params(8, cfg, device="cpu")      # bf16 LLM, as served
    dense = params["llava"]["phi3"]
    q = quantize_phi3(dense, bits=4)
    for lq, ld in zip(q["layers"], dense["layers"]):
        for name in ("qkv", "o", "gate_up", "down"):
            lq[name]["q4"] = pack_int4(ld[name], dblk=64, nblk=32)   # no packing padding
    params["llava"]["phi3"] = q
    return cfg, params


def phase_routes(ctx):
    """The small config through every decode route the flags and the batch
    select, on the card and on the CPU with the same int4 weights: every
    row's ids identical at every step, and the route's kernels launched."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    cfg, params = _tiny_int4_params(torch)
    on = {dev: _to_device(torch, params, dev) for dev in ("cpu", "cuda")}
    for route, B, env, want in ROUTES:
        gens = {}
        with _flags(env):
            for dev in ("cpu", "cuda"):
                runner = EpisodeRunner(on[dev], cfg, device=dev)
                feeds = [SyntheticRoomFeed(rgb_size=56, depth_size=32, seed=3 + i)
                         for i in range(B)]
                kernels.reset_counts()
                runner.run(feeds, max_steps=2, ignore_stop=True)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
                gens[dev] = [s["gens"] for s in runner.step_log]
        log(f"[routes] {route} B={B} launches {json.dumps(counts)} ids equal "
            f"{gens['cpu'] == gens['cuda']}")
        if gens["cpu"] != gens["cuda"]:
            raise AssertionError(f"route {route}: ids differ, cpu={gens['cpu']} cuda={gens['cuda']}")
        if any(counts[k] < 1 for k in want) or any(plain.values()):
            raise AssertionError(f"route {route}: kernels {want} not all launched ({counts}, "
                                 f"plain {plain})")


BATCHED = [
    ("b12_default", 12, {}, ("int4_mlp", "int4_matvec")),
    ("b1_split", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_SPEC_DECODE": "0"},
     ("decode_attn_layer", "int4_mlp_block")),
    ("b1_unfused_grid2d", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_INT4_GRID2D": "1"},
     ("int4_matvec2d", "int4_mlp")),
    ("b4_grouped", 4, {}, ("decode_attn", "int4_matvec")),
]


def _serving_params(ctx):
    """Full-width serving parameters on the card (shared by the episode
    and batched phases)."""
    torch = ctx["torch"]
    if "serve" not in ctx:
        from dynam3d_torch.config import Dynam3DConfig
        from dynam3d_torch.models import policy
        from dynam3d_torch.models.vlm.phi3 import quantize_phi3

        cfg = Dynam3DConfig()                  # YOLOv8-seg at FastSAM-x width, imgsz 576
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = policy.init_policy_params(gen, cfg, device="cuda")
        params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=4, consume=True)
        torch.cuda.synchronize()
        log(f"[serve] params built and quantized in {time.perf_counter() - t0:.1f} s")
        ctx["serve"] = (cfg, params)
    return ctx["serve"]


def phase_batched(ctx):
    """Full-width episodes of 2 steps on each decode route of this slice,
    every launch counter reset just before each run and read just after."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    cfg, params = _serving_params(ctx)
    total = {k: 0 for k in kernels.KERNELS}
    for name, B, env, want in BATCHED:
        runner = EpisodeRunner(params, cfg, device="cuda")
        feeds = [SyntheticRoomFeed(rgb_size=336, depth_size=256, views=1, seed=10 + i)
                 for i in range(B)]
        with _flags(env):
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counts()
            res = runner.run(feeds, max_steps=2, ignore_stop=True)
            torch.cuda.synchronize()
            counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
        log(f"[batched] {name}: launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
        if any(counts[k] < 1 for k in want):
            raise AssertionError(f"batched {name}: kernels {want} not all launched")
        if any(plain.values()):
            raise AssertionError(f"batched {name}: plain kernel versions ran: {plain}")
        if len(res) != B or any(r["steps"] != 2 or not math.isfinite(r["distance_to_goal"])
                                for r in res):
            raise AssertionError(f"batched {name}: results {res}")
        for st in runner.step_log:
            if (len(st["gens"]) != B or any(len(g) != cfg.llava.max_new_tokens for g in st["gens"])
                    or not st["mm_finite"]):
                raise AssertionError(f"batched {name}: step {st['step']} output malformed")
        if name == "b4_grouped" and not isinstance(runner.step_log[0]["tokens"], list):
            raise AssertionError("batched b4_grouped: the grouped speculative decoder did not run")
        for k in total:
            total[k] += counts[k]
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = [st["ms"] for st in runner.step_log]
        log(f"[batched] {name} {json.dumps(dict(B=B, ms_per_step=ms, peak_mem_gib=peak, passes=[st['passes'] for st in runner.step_log], tokens=[st['tokens'] for st in runner.step_log]))}")
        if name == "b12_default":
            b12_ms = ms[-1]
    ctx["batched_launches"] = total
    feeds = [SyntheticRoomFeed(rgb_size=336, depth_size=256, views=1, seed=40 + i)
             for i in range(12)]
    _profile_step(torch, EpisodeRunner(params, cfg, device="cuda"), b12_ms, feeds, "b12")


@contextlib.contextmanager
def _flags(env):
    """Set environment gates for a block and restore them after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bf16_tol(ref) -> float:
    """bf16 outputs of the same bf16-rounded chain summed in another order:
    a few bf16 steps at the output's scale."""
    return 1.6e-2 * max(1.0, ref.float().abs().max().item())


def phase_nerf(ctx):
    """Kernel C vs its plain version at the renderer's shapes."""
    torch = ctx["torch"]
    from dynam3d_torch.config import FieldsConfig
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.ops import kernels, nerf_mlp
    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_cuda, nerf_mlp_plain

    gen, timer = ctx["gen"], ctx["timer"]
    cfg = FieldsConfig()
    D = cfg.fts_dim
    mlp = init_render_params(gen, cfg, "cuda")["mlp"]
    w = [mlp["enc_hidden"][0], mlp["enc_hidden"][1], mlp["enc_out"], mlp["dec_hidden"][0],
         mlp["dec_hidden"][1], mlp["dec_out"]]
    wb = [t.to(torch.bfloat16) for t in w]

    def library(x):
        """The same chain as six bf16 torch.matmul calls (yardstick only)."""
        h = x.to(torch.bfloat16)
        for t in wb[:2]:
            h = torch.nn.functional.leaky_relu(h @ t, 0.01)
        eo = torch.nn.functional.leaky_relu(h @ wb[2], 0.01)
        h = eo[:, :D] + x.to(torch.bfloat16)
        for t in wb[3:5]:
            h = torch.nn.functional.leaky_relu(h @ t, 0.01)
        return h @ wb[5], eo[:, D]

    lib = kernels.library("nerf_mlp")
    nerf_mlp._bind(lib)
    max_clusters = ctypes.c_int(0)
    kernels.check(lib.nerf_mlp_max_clusters(D, ctypes.byref(max_clusters)), "nerf_mlp")
    rows_per_cluster = lib.nerf_mlp_rows()
    cluster_blocks = lib.nerf_mlp_cluster_blocks(D)

    # the weight kernel's copies: exactly the transposed bf16 roundings
    nerf_mlp._weight_cache.clear()
    wt, eo_col = nerf_mlp.kernel_weights(w)
    if not (torch.equal(wt, torch.cat([t[:, :D].t().to(torch.bfloat16) for t in w]))
            and torch.equal(eo_col, w[2][:, D].to(torch.bfloat16))):
        raise AssertionError("nerf_mlp_weights: the kernel's weight copies differ")

    def first_view(ws):
        """A call on a weight version the wrapper has not seen (the first
        view after an optimizer step): the bf16 copies are made anew."""
        nerf_mlp._weight_cache.clear()
        return nerf_mlp_cuda(x, *ws)

    rows, entry = [], None
    for N in (1152, 1152 + 37, 16 * 1152):   # one view, a ragged tile, 16 views
        x = torch.randn(N, D, generator=gen, device="cuda")
        ok, dk = nerf_mlp_cuda(x, *w)
        op, dp = nerf_mlp_plain(x, *w)
        torch.cuda.synchronize()
        err = max((ok.float() - op.float()).abs().max().item(),
                  (dk.float() - dp.float()).abs().max().item())
        tol = max(_bf16_tol(op), _bf16_tol(dp))
        if not (err <= tol and torch.isfinite(ok.float()).all() and torch.isfinite(dk.float()).all()):
            raise AssertionError(f"nerf_mlp N={N}: err {err} > {tol}")
        # f32 weights as the renderer passes them: the first view of a step
        # casts them, the later views find the cached copies
        ms = timer(lambda: first_view(w))
        ms_cached = timer(lambda: nerf_mlp_cuda(x, *w))
        # the first view on weights already in bf16, as the library chain gets them
        ms_bf16_w = timer(lambda: first_view(wb))
        plain_ms = timer(lambda: nerf_mlp_plain(x, *w), iters=3, warmup=1)
        lib_ms = timer(lambda: library(x))
        # inputs as the renderer hands them over: f32 x and f32 weights
        nbytes = x.numel() * 4 + sum(t.numel() * 4 for t in w) + N * D * 2 + N * 2
        b_ms, b_by = bound(nbytes, 2.0 * N * D * (6 * D + 1), ctx["card"])
        clusters = -(-N // rows_per_cluster)
        row = dict(N=N, D=D, rows_per_cluster=rows_per_cluster, cluster_blocks=cluster_blocks,
                   clusters=clusters, max_active_clusters=max_clusters.value,
                   waves=-(-clusters // max(1, max_clusters.value)),
                   max_abs_err=err, tol=tol, ms=ms, ms_cached_weights=ms_cached,
                   ms_bf16_weights=ms_bf16_w, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        rows.append(row)
        log(f"[nerf] {json.dumps(row)}")
        if N == 1152:
            entry = dict(row)
            if row["waves"] != 1:
                raise AssertionError(f"nerf_mlp N=1152: {clusters} clusters run in "
                                     f"{row['waves']} waves")
    ctx["nerf"] = dict(entry, max_abs_err=max(r["max_abs_err"] for r in rows), rows=rows)


def _knn_agree(torch, label, q, pts, valid, K, dk, ik, exact_ids=False):
    """Kernel D's (dk, ik) against ``knn_topk_plain`` on the same inputs:
    the same (1e10, -1) tails, distances within 1e-4, every id a live point
    once per row at the distance reported, ids equal where the distances are
    separated (all of them with ``exact_ids``), few ids differing."""
    from dynam3d_torch.ops.knn import knn_tiled, knn_topk_plain

    dp, ip = knn_topk_plain(q, pts, valid, K)
    # one neighbour more, only to know how far the k-th stands from the next
    d_next = knn_tiled(q, pts, valid, K + 1)[0][:, K]
    torch.cuda.synchronize()
    live = dp < 1e10
    if not torch.equal(live, dk < 1e10) or not torch.equal(ik[~live], ip[~live]):
        raise AssertionError(f"knn_topk {label}: the (1e10, -1) tails differ")
    # f32 expansion, d' = |p|^2 - 2 q.p by three FMAs plus |q|^2, vs the
    # matmul's q.p added to |q|^2 + |p|^2: a few float32 steps of |q|^2 +
    # |p|^2 (coordinates ~10 m)
    err = (dk[live] - dp[live]).abs().max().item() if bool(live.any()) else 0.0
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"knn_topk {label}: distance err {err} > {tol}")
    # the kernel's ids name live points, once each per row, at the distances
    # it reports: recompute them in float64 from the table
    lid = ik[live]
    if not (bool((lid >= 0).all()) and bool((lid < pts.shape[0]).all())
            and bool(valid[lid.clamp(0, pts.shape[0] - 1)].all())):
        raise AssertionError(f"knn_topk {label}: a live entry names a dead or out-of-range point")
    srt = ik.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError(f"knn_topk {label}: a point appears twice in one row")
    # (the f32 expansion is good to a few float32 steps of |q|^2 + |p|^2; a
    # wrong id lands metres away)
    q64, p64 = q.double()[:, None, :], pts.double()[ik.clamp(min=0)]
    d_at_ids = ((q64 - p64) ** 2).sum(-1)
    id_tol = 2e-6 * ((q64 ** 2).sum(-1) + (p64 ** 2).sum(-1)) + 1e-6
    off = torch.maximum((d_at_ids - dk.double()).abs(), (d_at_ids - dp.double()).abs())
    if bool((off > id_tol)[live].any()):
        raise AssertionError(f"knn_topk {label}: the distance at a kernel id is not the one reported")
    id_err = off[live].max().item() if bool(live.any()) else 0.0
    # where a distance stands more than 2 tol from its neighbours in the list
    # (and from the next point beyond it), its rank is fixed: the ids agree
    ext = torch.cat([torch.full_like(dp[:, :1], -float("inf")), dp, d_next[:, None]], 1)
    separated = live & (ext[:, 1:-1] - ext[:, :-2] > 2 * tol) & (ext[:, 2:] - ext[:, 1:-1] > 2 * tol)
    if not torch.equal(ik[separated], ip[separated]):
        raise AssertionError(f"knn_topk {label}: ids differ where the distances are separated")
    n_diff = int((ik != ip).sum().item())
    n_diff_limit = 0 if exact_ids else max(8, ik.numel() // 10_000)
    if n_diff > n_diff_limit:
        raise AssertionError(f"knn_topk {label}: {n_diff} ids differ (limit {n_diff_limit})")
    return dict(max_abs_err=err, tol=tol, max_dist_err_at_ids=id_err,
                ids_separated=int(separated.sum().item()), ids_differing=n_diff,
                ids_differing_limit=n_diff_limit, rows_with_tail=int((~live).any(1).sum().item()))


def _knn_hard_tables(torch, walk_pts, walk_valid, rays):
    """(label, queries, points, valid, k, forced grid or None, exact ids)
    of the tables that hold kernel D's edges: dead slots interleaved with
    the live ones, exact duplicate points whose copies lie in different
    pieces (ties must go to the smaller id), fewer than k live points
    spread over the pieces (the (1e10, -1) tail must survive the merge), no
    live point at all, k = 1 and 8, and query counts no tile divides."""
    import numpy as np

    rng = np.random.default_rng(11)
    out = []
    # interleaved dead slots: every third slot and 10% more of the walk
    valid = walk_valid.clone()
    valid[::3] = False
    valid &= torch.from_numpy(rng.uniform(size=valid.shape[0]) > 0.1).cuda()
    for k in (1, 8):
        out.append((f"interleaved_dead k={k} Q=10007", rays[:10007].contiguous(), walk_pts, valid,
                    k, None, False))
    # exact duplicates: a 16 x 16 x 8 grid of positions 1 m apart, three
    # copies each (copy c of position j at slot c * 2048 + j; 12 tiles of
    # 256 queries on 36 blocks cut each tile's table into its three
    # copies); queries near grid points at offsets whose three nearest
    # positions stand >= 0.1 m^2 apart
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    dup = torch.from_numpy(np.concatenate([g, g, g])).cuda()
    dup_valid = torch.ones(dup.shape[0], dtype=torch.bool, device="cuda")
    at = g[rng.integers(0, g.shape[0], 3001)]
    qd = at + np.array([0.05, 0.15, 0.30], np.float32) + rng.uniform(-0.01, 0.01, (3001, 3))
    qd = torch.from_numpy(qd.astype(np.float32)).cuda()
    for k in (1, 8):
        out.append((f"duplicates k={k} Q=3001", qd, dup, dup_valid, k, 36, True))
    # fewer than k live points: 20 tiles on 60 blocks, three or four pieces
    # a tile
    few = torch.zeros_like(walk_valid)
    few[[5, 3000, 6000, 9000, 12000, 15000, 20159]] = True
    out.append(("seven_live k=8 Q=5003", rays[:5003].contiguous(), walk_pts, few, 8, 60, True))
    out.append(("no_live k=4 Q=1001", rays[:1001].contiguous(), walk_pts,
                torch.zeros_like(walk_valid), 4, None, True))
    return out


def _knn_launch_checked(torch, label, q, pts, valid, k, plan):
    """Kernel D with ``plan``; the live count its prologue wrote must be
    the table's.  Returns (dist, idx, the pieces of each tile)."""
    from dynam3d_torch.ops.knn import knn_launch, knn_pieces

    d, i, n_live = knn_launch(q, pts, valid, k, plan)
    want = int(valid.sum().item())
    if int(n_live.item()) != want:
        raise AssertionError(f"knn_topk {label}: the prologue counted {int(n_live.item())} "
                             f"live points, not {want}")
    return d, i, [len(p) for p in knn_pieces(plan, want)]


def phase_knn(ctx):
    """Kernel D vs its plain version at the render stage-1 shape, then on
    the hard tables; the plan, the pieces a tile, the live count the
    prologue wrote, the bounds over the live pairs and over every slot."""
    torch = ctx["torch"]
    from dynam3d_torch.config import FieldsConfig
    from dynam3d_torch.ops.knn import card_plan, knn_topk_cuda, knn_topk_plain
    from dynam3d_torch.tools.decompose_knn import ray_samples, walk_table

    timer = ctx["timer"]
    cfg = FieldsConfig()
    K = cfg.search_num
    pts, valid = walk_table(cfg)[:2]
    q = ray_samples(cfg).reshape(-1, 3).contiguous()
    Q, P = q.shape[0], pts.shape[0]
    n_live = int(valid.sum().item())
    plan = card_plan(q.device, Q, K)
    dk, ik, pieces = _knn_launch_checked(torch, "stage-1", q, pts, valid, K, plan)
    check = _knn_agree(torch, "stage-1", q, pts, valid, K, dk, ik)
    log(f"[knn] plan {json.dumps(dict(r=plan.r, tile_q=plan.tile_q, tiles=plan.tiles, grid=plan.grid, sms=plan.sms, blocks_per_sm=plan.blocks_per_sm, waves=plan.grid / (plan.sms * plan.blocks_per_sm), pieces_per_tile=[min(pieces), max(pieces)], live_points_per_block=plan.tiles * n_live / plan.grid))}")

    for label, hq, hp, hv, hk, hgrid, exact in _knn_hard_tables(torch, pts, valid, q):
        hplan = card_plan(hq.device, hq.shape[0], hk, grid=hgrid)
        d, i, hpieces = _knn_launch_checked(torch, label, hq, hp, hv, hk, hplan)
        got = _knn_agree(torch, label, hq, hp, hv, hk, d, i, exact_ids=exact)
        log(f"[knn] hard table {label}: grid {hplan.grid}, pieces a tile "
            f"{min(hpieces, default=0)}-{max(hpieces, default=0)} {json.dumps(got)}")

    def library():
        outs = []
        for qc in q.split(4096):
            d = (qc * qc).sum(-1, keepdim=True) + (pts * pts).sum(-1)[None] - 2.0 * (qc @ pts.T)
            d = torch.where(valid[None], d.clamp(min=0.0), torch.full_like(d, 1e10))
            outs.append(torch.topk(d, K, dim=1, largest=False))
        return outs

    ms = timer(lambda: knn_topk_cuda(q, pts, valid, K))
    plain_ms = timer(lambda: knn_topk_plain(q, pts, valid, K), iters=3, warmup=1)
    lib_ms = timer(library, iters=5, warmup=1)
    nbytes = Q * 12 + P * 12 + P + Q * K * (4 + 8)
    # dead slots need no distance: the bound counts the live pairs; the
    # bound over every slot (the design before this one scanned them all)
    # is printed beside it
    b_ms, b_by = bound(nbytes, 8.0 * Q * n_live, ctx["card"], FP32_PEAK)
    b_all_ms, _ = bound(nbytes, 8.0 * Q * P, ctx["card"], FP32_PEAK)
    row = dict(Q=Q, P=P, k=K, live_points=n_live, **check, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bound_all_slots_ms=b_all_ms,
               share_of_bound=b_ms / ms, share_of_bound_all_slots=b_all_ms / ms, bytes=nbytes,
               r=plan.r, grid=plan.grid)
    log(f"[knn] {json.dumps(row)}")
    ctx["knn"] = row


def _render_state(torch, cfg):
    from dynam3d_torch.models.memory3d.state import init_state

    from dynam3d_torch.tools.decompose_knn import walk_table

    pts, valid, fts, pdir, pscale = walk_table(cfg)
    n = fts.shape[0]
    st = init_state(cfg, "cuda")
    patch_fts = st.patch_fts.clone()
    patch_fts[:n] = fts.to(patch_fts.dtype)
    patch_dir, patch_scale = st.patch_dir.clone(), st.patch_scale.clone()
    patch_dir[:n], patch_scale[:n] = pdir, pscale
    return st._replace(patch_pos=pts, patch_valid=valid, patch_fts=patch_fts,
                       patch_dir=patch_dir, patch_scale=patch_scale)


def phase_render(ctx):
    """One full-width novel view under both stage-1 k-NN configurations."""
    torch = ctx["torch"]
    from dynam3d_torch.config import FieldsConfig
    from dynam3d_torch.models.render import nerf
    from dynam3d_torch.ops import kernels

    cfg = FieldsConfig()
    params = nerf.init_render_params(ctx["gen"], cfg, "cuda")
    state = _render_state(torch, cfg)
    pos = torch.tensor([0.3, -0.2, 1.25], device="cuda")

    def view(k=0):
        return nerf.render_view(params, cfg, state, pos,
                                torch.tensor(0.7 + 0.05 * k, device="cuda"))

    def recorded_view(seen):
        """One view, with the stage-1 importance samples it composited."""
        real = nerf.raw2feature

        def recording(feat, dens, rel_dist, topk_inds):
            seen.append(topk_inds)
            return real(feat, dens, rel_dist, topk_inds)

        nerf.raw2feature = recording
        try:
            return view()
        finally:
            nerf.raw2feature = real

    outs, inds, ms = {}, {}, {}
    for name, env in (("banded", {}), ("kernel_d", KNN_FLAG_ENV)):
        with _flags(env):
            kernels.reset_counts()
            seen = []
            with torch.no_grad():
                outs[name] = recorded_view(seen)
            inds[name] = seen[0]
            torch.cuda.synchronize()
            counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
            log(f"[render] {name}: launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
            want = ["nerf_mlp"] + (["knn_topk"] if env else [])
            if any(counts[k] < 1 for k in want) or any(plain.values()):
                raise AssertionError(f"render {name}: kernels {want} not all launched")
            with torch.no_grad():
                for k in range(2):
                    view(k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for k in range(5):
                    view(k)
                torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3 / 5
    a, b = outs["banded"], outs["kernel_d"]
    for o in (a, b):
        if not all(torch.isfinite(t.float()).all() for t in o):
            raise AssertionError("render: non-finite output")
    # stage 1 only reads distances within the radius, where the banded scan
    # is exact; the two agree up to float rounding of the distances, which
    # can move an importance sample of a near-tie ray.  A ray with the same
    # importance samples runs the same stage 2 and kernel C rows: it agrees
    # to float rounding.  Only rays whose samples moved may differ.
    fa, fb = a.features.reshape(-1, cfg.fts_dim), b.features.reshape(-1, cfg.fts_dim)
    ray_err = (fa - fb).abs().amax(-1)
    depth_err = (a.depth - b.depth).abs().reshape(-1)
    same_samples = (inds["banded"] == inds["kernel_d"]).all(-1)
    n_rays, n_moved = same_samples.numel(), int((~same_samples).sum())
    if n_moved > max(2, n_rays // 32):
        raise AssertionError(f"render: {n_moved}/{n_rays} rays took other importance samples")
    err_same = max(ray_err[same_samples].max().item(), depth_err[same_samples].max().item())
    if not err_same <= 1e-5:
        raise AssertionError(f"render: rays with the same samples differ by {err_same}")
    hit = fa.norm(dim=-1) > 0.5
    row = dict(rays=n_rays, rays_with_other_samples=n_moved, max_err_same_samples=err_same,
               rays_hit=int(hit.sum()), max_feature_err=ray_err.max().item(),
               max_depth_err=depth_err.max().item(),
               ms_per_view_banded=ms["banded"], ms_per_view_kernel_d=ms["kernel_d"])
    log(f"[render] {json.dumps(row)}")
    if not bool(hit.any()):
        raise AssertionError("render: no ray hit the table")
    ctx["render"] = row


def phase_pretrain(ctx):
    """The full-width pretraining slice, launch counters reset just before
    the four counted iterations and read just after."""
    torch = ctx["torch"]
    from dynam3d_torch.config import Dynam3DConfig, SegmenterConfig
    from dynam3d_torch.models.encoders.clip import init_clip_params
    from dynam3d_torch.models.memory3d import init_field_params
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner, SyntheticFramesDataset
    from dynam3d_torch.runtime.trainer_3dff import tree_leaves

    cfg = Dynam3DConfig(segmenter=SegmenterConfig(provider="depth_plane"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    t0 = time.perf_counter()
    params = {"fields": init_field_params(gen, cfg.fields, "cuda"),
              "render": init_render_params(gen, cfg.fields, "cuda"),
              "clip": init_clip_params(gen, cfg.clip, "cuda")}
    before = [t.clone() for t in tree_leaves({k: params[k] for k in ("fields", "render")})]
    torch.cuda.synchronize()
    log(f"[pretrain] params built in {time.perf_counter() - t0:.1f} s")
    runner = PretrainRunner(params, cfg, device="cuda")
    unposed = SyntheticFramesDataset(rgb_size=336, depth_size=256, frames=16, seed=0)
    posed = SyntheticFramesDataset(rgb_size=336, depth_size=256, frames=4, seed=1, posed=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    hist = runner.run([unposed], iters=2)
    with _flags(KNN_FLAG_ENV):
        hist += runner.run([posed], iters=2)
    torch.cuda.synchronize()
    counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
    log(f"[pretrain] launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
    for name in ("nerf_mlp", "knn_topk"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the pretraining path")
    if plain["nerf_mlp"] or plain["knn_topk"]:
        raise AssertionError(f"plain kernel versions ran on the pretraining path: {plain}")
    for i, (m, t) in enumerate(zip(hist, runner.timings)):
        log(f"[pretrain] iter {i} {'posed' if i >= 2 else 'unposed'} "
            f"{json.dumps(dict(m, build_ms=t['build_s'] * 1e3, step_ms=t['step_s'] * 1e3))}")
        if m["skipped"] or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"pretraining iteration {i}: {m}")
    after = tree_leaves({k: runner.params[k] for k in ("fields", "render")})
    moved = sum((a.float() - b.float()).abs().sum().item() for a, b in zip(after, before))
    if not moved > 0:
        raise AssertionError("pretraining left the parameters where they were")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pretrain] params_moved_l1={moved:.6g} peak_mem_gib={peak:.2f}")
    ctx["pretrain_launches"] = counts
    steady = runner.timings[1]["build_s"] + runner.timings[1]["step_s"]
    _profile_pretrain(torch, runner, unposed, steady * 1e3)


def _profile_pretrain(torch, runner, dataset, steady_ms=None, label="pretrain"):
    """One more iteration of ``dataset`` under ``torch.profiler`` (outside
    the counted window): device time by kernel, and the device's busy and
    idle share of ``steady_ms`` (an un-profiled iteration's time), or of the
    profiled iteration's own synchronized wall time when it is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run([dataset], iters=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if steady_ms is None:
        steady_ms = wall_ms

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), key=lambda r: -r[1])
    if not rows:
        log("[profile] device time not measured (the profiler saw no kernels)")
        return
    busy_ms = sum(r[1] for r in rows) / 1e3
    log(f"[profile] {label} device_busy_ms={busy_ms:.1f} steady_iter_ms={steady_ms:.1f} "
        f"idle_share={max(0.0, 1 - busy_ms / steady_ms):.3f} kernels={len(rows)} "
        f"launches={sum(r[2] for r in rows)}")
    for key, us, n in rows[:15]:
        log(f"[profile] {us / 1e3:9.3f} ms  x{n:<6d} {key[:100]}")


CATEGORIES = ("wall", "floor", "ceiling", "door", "window", "chair", "table", "sofa", "bed",
              "cabinet", "shelf", "lamp", "plant", "picture", "counter", "sink")


def phase_walk(ctx):
    """The hm3d walk of 3DFF pretraining at full width: two episodes under
    the default flags (logger, a checkpoint per iteration) and one under the
    k-NN gates, each window's launch counters reset just before and read
    just after, then one profiled episode."""
    torch = ctx["torch"]
    import tempfile

    import numpy as np

    from dynam3d_torch.config import Dynam3DConfig, SegmenterConfig
    from dynam3d_torch.models.encoders import clip as clip_mod
    from dynam3d_torch.models.encoders.clip_tokenizer import hash_tokenize
    from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
    from dynam3d_torch.models.memory3d import init_field_params
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.models.waypoint.trm import init_waypoint_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.logging import MetricsLogger
    from dynam3d_torch.runtime.pretrain_loop import (
        PretrainRunner, WalkDriver, synthetic_supervision,
    )
    from dynam3d_torch.utils.tree import tree_leaves

    cfg = Dynam3DConfig(segmenter=SegmenterConfig(provider="depth_plane"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    t0 = time.perf_counter()
    params = {"fields": init_field_params(gen, cfg.fields, "cuda"),
              "render": init_render_params(gen, cfg.fields, "cuda"),
              "clip": clip_mod.init_clip_params(gen, cfg.clip, "cuda"),
              "depth_enc": init_depth_params(gen, cfg.depth, device="cuda"),
              "waypoint": init_waypoint_params(gen, cfg.waypoint, feature_dim(cfg.depth),
                                               device="cuda")}
    torch.cuda.synchronize()
    log(f"[walk] params built in {time.perf_counter() - t0:.1f} s; depth features "
        f"{feature_dim(cfg.depth)}, text tower {len(params['clip']['text']['transformer']['blocks'])}"
        f" x {cfg.clip.text_width}")

    # category embeddings from the text tower (the reference's CLIP text
    # features of the category names)
    sup = synthetic_supervision(0, cfg.fields.fts_dim, n_cats=len(CATEGORIES))
    tokens = torch.from_numpy(hash_tokenize([f"a photo of a {c}" for c in CATEGORIES],
                                            cfg.clip.text_context)).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        cat = clip_mod.encode_text(params["clip"], cfg.clip, tokens)
    torch.cuda.synchronize()
    text_ms = (time.perf_counter() - t0) * 1e3
    if tuple(cat.shape) != (len(CATEGORIES), cfg.clip.embed_dim) or not bool(cat.isfinite().all()):
        raise AssertionError(f"encode_text gave {tuple(cat.shape)}, finite {cat.isfinite().all()}")
    sup["cat_embeddings"] = cat.cpu().numpy()
    log(f"[walk] encode_text {len(CATEGORIES)} names in {text_ms:.1f} ms")

    runner = PretrainRunner(params, cfg, device="cuda")

    def walk(seed):
        return WalkDriver(SyntheticRoomFeed(rgb_size=336, depth_size=256, views=12, seed=seed),
                          sup, nv=4, max_len=cfg.train.pretrain_traj_len, seed=seed,
                          teacher_prob=cfg.train.sample_ratio * 0.5,
                          waypoint_aug=cfg.train.waypoint_aug)

    before = [t.clone() for t in tree_leaves({k: params[k] for k in ("fields", "render")})]
    tmp = tempfile.TemporaryDirectory()
    logger = MetricsLogger(os.path.join(tmp.name, "logs"))
    ckdir = os.path.join(tmp.name, "ck")
    torch.cuda.reset_peak_memory_stats()
    windows = {}
    kernels.reset_counts()
    hist = runner.run([walk(0)], iters=2, logger=logger, ckpt_dir=ckdir, log_every=1)
    torch.cuda.synchronize()
    windows["default"] = (dict(kernels.launches), dict(kernels.plain_calls))
    trained = {k: [t.clone() for t in tree_leaves(runner.params[k])] for k in ("fields", "render")}
    logger.close()
    kernels.reset_counts()
    with _flags(KNN_FLAG_ENV):
        hist += runner.run([walk(1)], iters=1)
    torch.cuda.synchronize()
    windows["knn"] = (dict(kernels.launches), dict(kernels.plain_calls))
    peak = torch.cuda.max_memory_allocated() / 2**30

    for label, (counts, plain) in windows.items():
        log(f"[walk] {label} launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
        if any(plain.values()):
            raise AssertionError(f"plain kernel versions ran on the walk path ({label}): {plain}")
        if counts["nerf_mlp"] <= 0:
            raise AssertionError(f"kernel nerf_mlp was not launched on the walk path ({label})")
    if windows["knn"][0]["knn_topk"] <= 0:
        raise AssertionError("kernel knn_topk was not launched on the walk path under the gates")
    for i, (m, t) in enumerate(zip(hist, runner.timings[-3:])):
        steps = t["walk_steps"]
        log(f"[walk] iter {i} {'knn' if i == 2 else 'default'} {json.dumps(m)} "
            f"iter_ms={t['walk_s'] * 1e3:.1f} step_ms={t['walk_s'] * 1e3 / steps:.1f} "
            f"heatmap_ms={t['heatmap_s'] * 1e3:.1f} views_ms={t['views_s'] * 1e3:.1f} "
            f"grad_ms={t['grad_s'] * 1e3:.1f} update_ms={t['update_s'] * 1e3:.1f}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"walk iteration {i}: {m}")
        if not 1 <= m["walk_steps"] <= cfg.train.pretrain_traj_len:
            raise AssertionError(f"walk iteration {i}: walk_steps {m['walk_steps']}")
    after = tree_leaves({k: runner.params[k] for k in ("fields", "render")})
    moved = sum((a.float() - b.float()).abs().sum().item() for a, b in zip(after, before))
    if not moved > 0:
        raise AssertionError("the walk left the parameters where they were")

    with open(os.path.join(tmp.name, "logs", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    names = sorted(os.listdir(ckdir))
    newest = os.path.join(ckdir, max(names, key=ckpt_mod.checkpoint_step))
    loaded = ckpt_mod.load_checkpoint(newest)
    for k in ("fields", "render"):
        for a, b in zip(tree_leaves(loaded[k]), trained[k]):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"checkpoint {newest} does not load back {k}")
    if names != ["ckpt.iter1", "ckpt.iter2"] or {r["step"] for r in rows} != {0, 1}:
        raise AssertionError(f"checkpoints {names}, logged steps {sorted({r['step'] for r in rows})}")
    log(f"[walk] params_moved_l1={moved:.6g} peak_mem_gib={peak:.2f} checkpoints {names} "
        f"round trip ok, {len(rows)} logged scalars")
    tmp.cleanup()
    ctx["walk_launches"] = {k: windows["default"][0][k] + windows["knn"][0][k]
                            for k in ("nerf_mlp", "knn_topk")}
    _profile_pretrain(torch, runner, walk(0), label="walk")


def _device_kernels(torch, prof) -> int:
    """Kernel launches on the card recorded by a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def phase_yolo(ctx):
    """One full-width ``segment_views`` on the card and on the CPU with the
    same weights: ``forward`` within tolerance, the same NMS picks, the same
    ids where no kept mask lies within 1e-3 of 0.5 at a sampled cell; ms per
    view and the NMS loop's launches."""
    torch = ctx["torch"]
    from torch.profiler import ProfilerActivity, profile

    from dynam3d_torch.config import SegmenterConfig
    from dynam3d_torch.models.encoders import yolov8_seg as Y
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    seg = SegmenterConfig()
    grid, max_segments = (24, 24), 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = Y.init_yolov8_params(gen, width=seg.width_mult, depth_n=seg.depth_layers(),
                                  num_protos=seg.num_protos, device="cuda")
    cpu_params = _to_device(torch, params, "cpu")
    rgb = torch.from_numpy(SyntheticRoomFeed(rgb_size=336, depth_size=256, views=1,
                                             seed=0).reset().rgb)           # [1, 336, 336, 3]
    s = seg.imgsz
    x = Y.resize_bilinear(rgb.to(torch.float32) / 255.0, s, s)              # on the CPU
    outs, picks, ids = {}, {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        with torch.no_grad():
            outs[dev] = Y.forward(p, x.to(dev), depth_n=seg.depth_layers())
            picks[dev] = Y.nms_select(outs[dev].boxes, outs[dev].scores, seg.conf, seg.iou,
                                      seg.max_masks)
            ids[dev] = Y.segment_views(p, seg, rgb.to(dev), grid, max_segments)
    torch.cuda.synchronize()
    # float32 convolutions, cuDNN vs the CPU, over 100 of them: summation order only
    errs = {}
    for name in Y.SegOutput._fields:
        ref = getattr(outs["cpu"], name)
        errs[name] = _check(f"yolo forward {name}", getattr(outs["cuda"], name).cpu(), ref,
                            1e-3 * max(1.0, ref.abs().max().item()))
    same_picks = all(torch.equal(a.cpu(), b) for a, b in zip(picks["cuda"], picks["cpu"]))
    # kept masks within 1e-3 of 0.5 at the cells the id map samples
    o, (idx, valid) = outs["cpu"], picks["cpu"]
    m = torch.sigmoid(torch.einsum("bhwc,bmc->bmhw", o.protos,
                                   torch.gather(o.coeffs, 1, idx[..., None].expand(-1, -1, o.coeffs.shape[-1]))))
    step = o.protos.shape[1] // grid[0]
    near = ((m[:, :, ::step, ::step] - 0.5).abs() < 1e-3) & valid[:, :, None, None]
    n_near = int(near.sum())
    same_ids = torch.equal(ids["cuda"].cpu(), ids["cpu"])
    kept = int(valid.sum())
    if not same_picks or (n_near == 0 and not same_ids):
        raise AssertionError(f"yolo: card and CPU differ (picks equal {same_picks}, ids equal "
                             f"{same_ids}, near-threshold cells {n_near})")
    if kept < 1 or int(ids["cuda"].max()) < 1:
        raise AssertionError(f"yolo: {kept} masks kept, ids {ids['cuda'].unique().tolist()}")

    def view():
        return Y.segment_views(params, seg, rgb.cuda(), grid, max_segments)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    ms = timed(view)
    ms12 = timed(lambda: Y.segment_views(params, seg, rgb.cuda().expand(12, -1, -1, -1), grid,
                                         max_segments), reps=2) / 12
    o = outs["cuda"]
    Y.nms_select(o.boxes, o.scores, seg.conf, seg.iou, seg.max_masks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        Y.nms_select(o.boxes, o.scores, seg.conf, seg.iou, seg.max_masks)
        torch.cuda.synchronize()
    nms_launches = _device_kernels(torch, prof)
    nms_ms = timed(lambda: Y.nms_select(o.boxes, o.scores, seg.conf, seg.iou, seg.max_masks))
    row = dict(imgsz=s, width=seg.width_mult, depth=list(seg.depth_layers()),
               anchors=o.scores.shape[1], forward_err=errs, masks_kept=kept,
               same_nms_picks=same_picks, same_ids=same_ids, near_threshold_cells=n_near,
               segments=int(ids["cuda"].max()) + 1, ms_per_view=ms, ms_per_view_b12=ms12,
               nms_ms=nms_ms, nms_launches=nms_launches)
    log(f"[yolo] {json.dumps(row)}")
    ctx["yolo"] = row


def phase_stream(ctx):
    """Kernels I and J against their plain versions at the tools' shapes,
    then both tools' sweeps with the launch counters reset just before and
    read just after."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import int4_stream as S
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.tools import bench_int4_stream as stream_tool
    from dynam3d_torch.tools import bench_int4_unpack as unpack_tool

    timer = ctx["timer"]
    x, q4, sl, sh = stream_tool.make_weights(device="cuda")
    nw, d, n2 = q4.shape
    dblk = stream_tool.DBLK
    # the weights dequantized to bf16 for the yardstick: [NW, D, N]
    lo, hi = (q4.to(torch.int32) & 15) - 8, q4.to(torch.int32) >> 4
    wd = torch.cat([(lo.view(nw, d // dblk, dblk, n2) * sl[:, :, None]).view(nw, d, n2),
                    (hi.view(nw, d // dblk, dblk, n2) * sh[:, :, None]).view(nw, d, n2)],
                   -1).to(torch.bfloat16)
    del lo, hi
    lib_ms = timer(lambda: torch.matmul(x, wd))
    del wd
    nbytes = q4.numel() + 4 * (sl.numel() + sh.numel()) + x.numel() * 2 + nw * 8 * 2 * n2 * 4
    b_ms, b_by = bound(nbytes, 2.0 * nw * 8 * d * 2 * n2, ctx["card"])

    def tol(ref, rel=1e-5):
        return rel * max(1.0, ref.abs().max().item())

    def plan_row(body, Sv, nblk):
        """The launch plan of (body, S, nblk): kc, kslice, work items, and the
        card's blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
        and dynamic shared memory of a block, from which the plan is made."""
        p = S.plan(q4, body, Sv, nblk, dblk)
        return dict(S=Sv, nblk=nblk, kc=S.KC, kslice=p.kslice, items=p.items,
                    blocks_per_sm=p.blocks_per_sm, smem=p.smem)

    rows, entries = [], {}
    for Sv, nblk in S.STREAM_VARIANTS:
        yk = S.int4_stream_matvec_cuda(x, q4, sl, sh, S=Sv, nblk=nblk, dblk=dblk)
        yp = S.int4_stream_matvec_plain(x, q4, sl, sh, dblk=dblk)
        torch.cuda.synchronize()
        err = _check(f"int4_stream_matvec S={Sv} nblk={nblk}", yk, yp, tol(yp))
        ms = timer(lambda: S.int4_stream_matvec_cuda(x, q4, sl, sh, S=Sv, nblk=nblk, dblk=dblk))
        row = dict(kernel="int4_stream_matvec", **plan_row("andtrick", Sv, nblk),
                   max_abs_err=err, tol=tol(yp), ms=ms, bound_ms=b_ms, bound_by=b_by,
                   bound_share=b_ms / ms, library_ms=lib_ms, bytes=nbytes)
        if (Sv, nblk) == (2, 512):
            row["plain_ms"] = timer(lambda: S.int4_stream_matvec_plain(x, q4, sl, sh, dblk=dblk),
                                    iters=3, warmup=1)
            entries["int4_stream_matvec"] = row
        rows.append(row)
        log(f"[stream] {json.dumps(row)}")
    xi, _ = unpack_tool.quantize_rows(x)
    outs = {}
    for body in S.UNPACK_BODIES:
        xb, qb = (xi if body == "w4a8" else x), unpack_tool.feed(body, q4)
        yk = S.int4_unpack_matvec_cuda(xb, qb, sl, sh, body=body, dblk=dblk)
        yp = S.int4_unpack_matvec_plain(xb, qb, sl, sh, body=body, dblk=dblk)
        torch.cuda.synchronize()
        if body == "dma-floor":
            if not (torch.equal(yk[:, :, :n2], yp[:, :, :n2]) and not yk[:, :, n2:].any()):
                raise AssertionError("int4_unpack_matvec dma-floor: not the weight rows")
            err, t = 0.0, 0.0
        else:
            # w4a8: exact int32 sums, only the f32 scaling differs
            t = tol(yp, 1e-6 if body == "w4a8" else 1e-5)
            err = _check(f"int4_unpack_matvec {body}", yk, yp, t)
        outs[body] = yk
        ms = timer(lambda: S.int4_unpack_matvec_cuda(xb, qb, sl, sh, body=body, dblk=dblk))
        row = dict(kernel="int4_unpack_matvec", body=body,
                   **plan_row(body, S.UNPACK_S, S.UNPACK_NBLK), max_abs_err=err, tol=t, ms=ms,
                   bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, library_ms=lib_ms,
                   bytes=nbytes)
        if body == "andtrick":
            row["plain_ms"] = timer(lambda: S.int4_unpack_matvec_plain(xb, qb, sl, sh, body=body,
                                                                       dblk=dblk),
                                    iters=3, warmup=1)
            entries["int4_unpack_matvec"] = row
        rows.append(row)
        log(f"[stream] {json.dumps(row)}")
    err_ca = _check("current vs andtrick", outs["current"], outs["andtrick"],
                    tol(outs["andtrick"]))
    log(f"[stream] current vs andtrick max_abs_err={err_ca}")
    del outs, x, q4, sl, sh

    kernels.reset_counts()
    sweep_i = stream_tool.sweep(device="cuda", log=lambda m: log(f"[stream] {m}"))
    sweep_j = unpack_tool.sweep(device="cuda", log=lambda m: log(f"[stream] {m}"))
    torch.cuda.synchronize()
    counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
    log(f"[stream] launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
    for name in ("int4_stream_matvec", "int4_unpack_matvec"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by the tools")
    if any(plain.values()):
        raise AssertionError(f"plain kernel versions ran in the tools: {plain}")
    floor_us = 1e3 * (d * n2 + 8 * (d // dblk) * n2) / mem_rate(ctx["card"]) * 1e3
    log(f"[stream] bytes bound per weight {floor_us:.2f} us; sweeps "
        f"{json.dumps(dict(stream=sweep_i, unpack=sweep_j))}")
    for name in entries:
        entries[name]["launches"] = counts[name]
        entries[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["kernel"] == name)
    ctx["stream"] = entries


def _nms_rounds(torch, cfg, heatmap):
    """The waypoint NMS of ``extract_candidates`` round by round on one
    heatmap ``[1, 120, 12]``: each round's flat pick in the wrapped map and
    its margin (the gap from the pick to the next value of the suppressed
    map; a margin below the heatmaps' disagreement can pick another peak)."""
    wc = cfg.waypoint
    probs = torch.softmax(heatmap.float().reshape(1, -1), dim=1).reshape(1, wc.num_angles,
                                                                        wc.n_classes)
    supp = torch.cat([probs[:, -1:], probs, probs[:, :1]], dim=1)[0]
    H, W = supp.shape
    xs = torch.arange(W, dtype=torch.float32, device=supp.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=supp.device)[:, None]
    picks, margins = [], []
    for _ in range(wc.max_candidates):
        top2 = torch.topk(supp.reshape(-1), 2)
        ix = int(torch.argmax(supp.reshape(-1)))
        picks.append(ix)
        margins.append(float(top2.values[0] - top2.values[1]))
        dx = xs - float(ix % W)
        dx = torch.minimum(dx.abs(), (dx + W).abs())
        dy = ys - ix / W
        g = ((dx.abs() <= wc.nms_sigma[0]) & (dy.abs() <= wc.nms_sigma[1])).float()
        supp = supp * (1.0 - g)
    return picks, margins, float(probs.max())


def _vln_card_vs_cpu(torch, devices=("cpu", "cuda")):
    """One ``VLNTrainer`` step of the small config (float32 Phi-3, lr 1e-3,
    a 12-view feed) on the CPU and on the card from the same weights."""
    import dataclasses

    from dynam3d_torch.models import policy
    from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
    from dynam3d_torch.models.waypoint.trm import init_waypoint_params
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.trainer_vln import split_params
    from dynam3d_torch.runtime.vln_loop import VLNTrainer
    from dynam3d_torch.utils.tree import tree_leaves, tree_map

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=1e-3))
    gen = torch.Generator().manual_seed(11)
    base = policy.init_policy_params(gen, cfg, llm_dtype=torch.float32, device="cpu")
    dep = init_depth_params(gen, cfg.depth, device="cpu")
    wp = init_waypoint_params(gen, cfg.waypoint, feature_dim(cfg.depth), device="cpu")
    before = [t.clone() for t in tree_leaves(split_params(base)[0])]
    runs = []
    for dev in devices:
        # each trainer updates its own copy of the weights in place
        feed = SyntheticRoomFeed(rgb_size=56, depth_size=64, views=12, seed=3)
        tr = VLNTrainer(tree_map(lambda t: t.to(dev, copy=True), base), cfg, lambda: feed,
                        waypoint_params=_to_device(torch, wp, dev),
                        depth_enc_params=_to_device(torch, dep, dev), device=dev)
        dep12 = torch.from_numpy(feed.reset().depth[None]).to(dev)
        heat = tr.waypoint_heatmap(dep12).cpu()
        cands = tr._waypoint_candidates(dep12)
        tr.train_episode(feed, max_steps=1)
        runs.append(dict(heat=heat, cands=[c[0].cpu() for c in cands], log=tr.step_log[0],
                         leaves=[t.cpu() for t in tree_leaves(tr.trainable)],
                         picks=_nms_rounds(torch, cfg, heat)))
    c, g = runs
    loss_err = abs(g["log"]["loss"] - c["log"]["loss"]) / abs(c["log"]["loss"])
    heat_err = float((g["heat"] - c["heat"]).abs().max() / c["heat"].abs().max())
    worst_flip, worst_err = 0.0, 0.0
    for p0, tc, tg in zip(before, c["leaves"], g["leaves"]):
        uc, ug = (tc - p0).double(), (tg - p0).double()
        size = float(uc.abs().max())
        flipped = (torch.sign(uc) * torch.sign(ug)) < 0
        worst_flip = max(worst_flip, float(flipped.float().mean()))
        if size > 0 and bool((~flipped).any()):
            worst_err = max(worst_err, float((ug - uc)[~flipped].abs().max()) / size)
    picks_c, margins, pmax = c["picks"]
    picks_g = g["picks"][0]
    # heatmap logits agree within heat_tol of their scale; a probability
    # then moves by at most ~pmax * 2 * heat_tol * scale
    heat_tol = 5e-4
    prob_tol = pmax * 2 * heat_tol * float(c["heat"].abs().max())
    sure = 0
    while sure < len(margins) and margins[sure] > prob_tol:
        sure += 1
    rec = dict(loss_cpu=c["log"]["loss"], loss_cuda=g["log"]["loss"], loss_rel_err=loss_err,
               grad_norm_cpu=c["log"]["grad_norm"], grad_norm_cuda=g["log"]["grad_norm"],
               update_max_err_of_size=worst_err, update_flipped_share=worst_flip,
               heatmap_rel_err=heat_err, nms_margins=margins, prob_tol=prob_tol,
               picks_cpu=picks_c, picks_cuda=picks_g, rounds_beyond_tol=sure,
               gt=[c["log"]["gt"], g["log"]["gt"]])
    log(f"[vln] card vs cpu {json.dumps(rec)}")
    if not (loss_err <= 1e-3 and heat_err <= heat_tol and worst_flip <= 5e-3
            and worst_err <= 1e-3):
        raise AssertionError(f"vln card vs cpu step disagrees: {rec}")
    if picks_g[:sure] != picks_c[:sure]:
        raise AssertionError(f"vln: NMS picks differ beyond the tolerance margin: {rec}")
    if sure == len(margins):
        # the same picks give the same distances, views and mask; an angle
        # (3-degree bins) may round an f32 ulp apart
        angles_c, dists_c, views_c, mask_c = c["cands"]
        angles_g, dists_g, views_g, mask_g = g["cands"]
        if not (torch.equal(dists_c, dists_g) and torch.equal(views_c, views_g)
                and torch.equal(mask_c, mask_g)
                and torch.allclose(angles_c, angles_g, rtol=1e-6, atol=0)):
            raise AssertionError(f"vln: candidates differ with every margin clear: {rec}")
        if c["log"]["gt"] != g["log"]["gt"]:
            raise AssertionError(f"vln: gt texts differ: {rec}")
    return rec


def phase_vln(ctx):
    """The VLN second stage at full width: IL training with the waypoint
    predictor, a checkpoint round trip, then eval and inference on the
    int4-quantized trained weights, and a small card-vs-CPU step."""
    torch = ctx["torch"]
    import dataclasses
    import tempfile

    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models import policy
    from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3
    from dynam3d_torch.models.waypoint.trm import init_waypoint_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime import vln_loop
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.trainer_vln import merge_params
    from dynam3d_torch.utils.tree import tree_leaves, tree_map

    ckdir = tempfile.TemporaryDirectory()
    cfg = Dynam3DConfig()
    # one episode of 3 steps, saved; the requeued trainer resumes from it
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, max_traj_len=3, iters=1, log_every=1, ckpt_dir=ckdir.name))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = policy.init_policy_params(gen, cfg, device="cuda")        # Phi-3 in bf16
    dep = init_depth_params(gen, cfg.depth, device="cuda")
    wp = init_waypoint_params(gen, cfg.waypoint, feature_dim(cfg.depth), device="cuda")
    torch.cuda.synchronize()
    log(f"[vln] params built in {time.perf_counter() - t0:.1f} s; phi3 "
        f"{params['llava']['phi3']['layers'][0]['qkv'].dtype}, depth features "
        f"{feature_dim(cfg.depth)}")

    def feed12():
        return SyntheticRoomFeed(rgb_size=336, depth_size=256, views=12, seed=0)

    trainer = vln_loop.VLNTrainer(params, cfg, feed12, waypoint_params=wp,
                                  depth_enc_params=dep, device="cuda")
    calls = {"n": 0}
    predictor = trainer._waypoint_fn

    def counted(d):
        calls["n"] += 1
        return predictor(d)

    trainer._waypoint_fn = counted
    groups = {k: tree_leaves(v) for k, v in trainer.trainable.items()}
    before = {k: [t.clone() for t in v] for k, v in groups.items()}
    save = ckpt_mod.save_checkpoint
    save_s = []

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*args, **kw)
        save_s.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    ckpt_mod.save_checkpoint = timed_save
    try:
        t0 = time.perf_counter()
        start = trainer.run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        ckpt_mod.save_checkpoint = save
    train_counts, train_plain = dict(kernels.launches), dict(kernels.plain_calls)
    for st in trainer.step_log:
        log(f"[vln] train step {json.dumps(st)}")
    moved = {k: sum(int(not torch.equal(a, b)) for a, b in zip(before[k], groups[k]))
             for k in groups}
    del before
    log(f"[vln] run() s={train_s:.1f} (from step {start}; save_checkpoint s={save_s}) "
        f"predictor_calls={calls['n']} tensors moved "
        f"{json.dumps({k: f'{moved[k]}/{len(groups[k])}' for k in groups})} launches "
        f"{json.dumps(train_counts)} plain calls {json.dumps(train_plain)}")
    log_ = trainer.step_log
    if (len(log_) != 3 or any(st["skipped"] or not math.isfinite(st["loss"])
                              or not math.isfinite(st["grad_norm"]) for st in log_)):
        raise AssertionError(f"vln: the IL episode is not 3 finite, unskipped steps: {log_}")
    if calls["n"] < 1 or not any(st["from_predictor"] for st in log_):
        raise AssertionError("vln: the waypoint predictor gave no candidates")
    if any(moved[k] == 0 for k in groups if k != "phi3"):
        raise AssertionError(f"vln: a projector tree did not move: {moved}")
    if any(train_plain.values()):
        raise AssertionError(f"vln: plain kernel versions ran in training: {train_plain}")

    # the checkpoint run() wrote, resumed by a requeued run() of a second
    # trainer, which then has no episode left to train
    blank = merge_params(tree_map(torch.zeros_like, trainer.trainable), trainer.frozen)
    requeued = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, is_requeue=True))
    second = vln_loop.VLNTrainer(blank, requeued, feed12, waypoint_params=wp,
                                 depth_enc_params=dep, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = second.run()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(trainer.trainable),
                                                 tree_leaves(second.trainable)))
    same_opt = second.opt_state["count"] == trainer.opt_state["count"] and all(
        torch.equal(a, b) for key in ("v_row", "v_col", "v")
        for a, b in zip(tree_leaves(trainer.opt_state[key]), tree_leaves(second.opt_state[key])))
    ck_bytes = sum(os.path.getsize(os.path.join(ckdir.name, f)) for f in os.listdir(ckdir.name))
    log(f"[vln] checkpoint {sorted(os.listdir(ckdir.name))} {ck_bytes / 2**30:.2f} GiB; "
        f"requeued run() resumed step={step} in {resume_s:.1f} s, episodes trained "
        f"{second._episodes_done}, identical_params={same} identical_opt_state={same_opt}")
    n_second = second._episodes_done
    del second, blank
    ckdir.cleanup()
    if start != 0 or len(save_s) != 1 or step != 1 or n_second != 0 or not same or not same_opt:
        raise AssertionError("vln: the resumed trainer differs from the saved one")
    steady = sum(st["ms"] for st in log_[1:]) / (len(log_) - 1)
    dep12 = torch.from_numpy(feed12().reset().depth[None]).to("cuda")
    trainer._waypoint_fn(dep12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer._waypoint_fn(dep12)
    torch.cuda.synchronize()
    log(f"[vln] waypoint predictor (12 x 256^2 depth -> candidates): "
        f"{(time.perf_counter() - t0) * 1e3 / 5:.2f} ms a call (host clock, synchronized)")
    _profile_train_step(torch, trainer, feed12(), steady)

    # eval and inference on the int4-quantized trained tree
    trained = trainer.params()
    trained["llava"] = dict(trained["llava"], phi3=quantize_phi3(trained["llava"]["phi3"], bits=4,
                                                                   consume=True))
    del trainer, groups
    torch.cuda.empty_cache()
    outdir = tempfile.TemporaryDirectory()
    gt_paths = _gt_paths()
    kernels.reset_counts()
    t0 = time.perf_counter()
    agg = vln_loop.evaluate(trained, cfg, [SyntheticRoomFeed(rgb_size=336, depth_size=256,
                                                             seed=20 + i) for i in range(2)],
                            gt_paths, out_dir=outdir.name, ckpt_name="vln", ignore_stop=True,
                            device="cuda")
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = {}
    for fmt in ("r2r", "rxr"):
        paths[fmt] = vln_loop.inference(
            trained, cfg, [SyntheticRoomFeed(rgb_size=336, depth_size=256, seed=30 + i)
                           for i in range(2)], ["ep0", "ep1"],
            out_path=os.path.join(outdir.name, f"preds_{fmt}.json"), fmt=fmt, device="cuda")
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
    files = sorted(os.listdir(outdir.name))
    per_ep = json.load(open(os.path.join(outdir.name, "stats_ep_vln_r0_w1.json")))
    rxr = [json.loads(r) for r in open(os.path.join(outdir.name, "preds_rxr.json"))]
    outdir.cleanup()
    eval_steps = int(sum(e["steps_taken"] for e in per_ep.values()))
    log(f"[vln] evaluate {json.dumps(agg)} in {eval_s:.1f} s ({eval_steps} steps, "
        f"{eval_s * 1e3 / eval_steps:.1f} ms a step); inference r2r+rxr in {infer_s:.1f} s, "
        f"poses {[len(p) for p in paths['r2r'].values()]}; files {files}")
    log(f"[vln] eval+inference launches {json.dumps(counts)} plain calls {json.dumps(plain)}")
    if any(counts[k] < 1 for k in ("int4_matvec", "decode_attn")):
        raise AssertionError("vln: kernels A and B did not both launch in eval and inference")
    if any(plain.values()):
        raise AssertionError(f"vln: plain kernel versions ran in eval / inference: {plain}")
    if (sorted(per_ep) != ["0", "1"] or any(e["steps_taken"] != 3.0 for e in per_ep.values())
            or not all(math.isfinite(v) for v in agg.values())
            or [r["instruction_id"] for r in rxr] != ["ep0", "ep1"]
            or any(p[-1]["stop"] is not True for p in paths["r2r"].values())):
        raise AssertionError(f"vln: eval / inference output malformed: {agg} {per_ep} {rxr}")
    ctx["vln_launches"] = counts
    del trained
    torch.cuda.empty_cache()
    ctx["vln"] = _vln_card_vs_cpu(torch)


def _profile_train_step(torch, trainer, feed, steady_ms):
    """One more 1-step episode of ``trainer`` (outside the counted window)
    with its IL step alone under ``torch.profiler`` (the waypoint predictor
    and the host's feed and tokenizer work stay outside): that step's device
    busy time, its own wall time (host clock, synchronized at both ends,
    the profiler on), the idle share of that wall time, and the top
    kernels.  ``steady_ms``, the un-profiled steps' mean, is printed
    beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_fn = trainer._step_fn
    seen = {}

    def profiled(*args):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            seen["ms"] = (time.perf_counter() - t0) * 1e3
        seen["prof"] = prof
        return out

    trainer._step_fn = profiled
    try:
        trainer.train_episode(feed, max_steps=1)
    finally:
        trainer._step_fn = step_fn

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(((e.key, dev_us(e), e.count) for e in seen["prof"].key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), key=lambda r: -r[1])
    if not rows:
        log("[profile] device time not measured (the profiler saw no kernels)")
        return
    busy = sum(r[1] for r in rows) / 1e3
    log(f"[profile] vln_train step device_busy_ms={busy:.1f} step_wall_ms={seen['ms']:.1f} "
        f"idle_share={max(0.0, 1 - busy / seen['ms']):.3f} (steady un-profiled "
        f"step_ms={steady_ms:.1f}) kernels={len(rows)} launches={sum(r[2] for r in rows)}")
    for key, us, n in rows[:12]:
        log(f"[profile] {us / 1e3:9.3f} ms  x{n:<6d} {key[:100]}")


def _gt_paths():
    import numpy as np

    return [np.float32([[2.0, 1.25, 2.0], [4.0, 1.25, 4.0], [6.0, 1.25, 6.0]])] * 2


METRIC_KEYS = {"steps_taken", "distance_to_goal", "success", "oracle_success", "path_length",
               "collisions", "spl", "ndtw", "sdtw"}


def _finite_metrics(label, metrics):
    if set(metrics) != METRIC_KEYS or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli {label}: metrics {metrics}")


def phase_cli(ctx):
    """The run CLI for its three run types and both trainers, then the eval
    soak, at full width in a temporary working directory: each step's
    files checked, its wall time, peak memory and launches printed."""
    torch = ctx["torch"]
    import gc
    import tempfile

    from dynam3d_torch import run
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import vln_loop
    from dynam3d_torch.tools import eval_soak

    seen = {}
    evaluate = vln_loop.evaluate

    def recording(params, cfg, feeds, *a, **k):
        seen["eval"] = [(type(f).__name__, f.rgb_size, f.depth_size) for f in feeds]
        return evaluate(params, cfg, feeds, *a, **k)

    steps = [
        ("eval", ["--run-type", "eval", "--exp_name", "smoke", "train.max_traj_len=3"]),
        ("inference", ["--run-type", "inference", "--exp_name", "smoke",
                       "train.max_traj_len=3"]),
        ("train_Dynam3D", ["--run-type", "train", "--trainer", "Dynam3D", "--exp_name", "il",
                           "train.iters=1", "train.max_traj_len=3", "train.log_every=1"]),
        ("train_SS-ETP", ["--run-type", "train", "--trainer", "SS-ETP", "--exp_name", "pre",
                          "train.iters=2"]),
        ("soak", ["--out", "soak", "--episodes", "2"]),
    ]
    tmp = tempfile.TemporaryDirectory()
    cwd = os.getcwd()
    os.chdir(tmp.name)
    vln_loop.evaluate = recording
    windows = {}
    try:
        for name, argv in steps:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counts()
            t0 = time.perf_counter()
            out = eval_soak.main(argv) if name == "soak" else run.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            windows[name] = counts
            log(f"[cli] {name} wall_s={wall:.2f} peak_mem_gib={peak:.2f} launches "
                f"{json.dumps({k: v for k, v in counts.items() if v})} plain calls "
                f"{json.dumps({k: v for k, v in plain.items() if v})}")
            if any(plain.values()):
                raise AssertionError(f"cli {name}: plain kernel versions ran: {plain}")
            if name == "eval":
                per_ep = json.load(open("data/eval/smoke/stats_ep_ckpt_r0_w1.json"))
                agg = json.load(open("data/eval/smoke/stats_ckpt.json"))
                if sorted(per_ep, key=int) != [str(i) for i in range(8)]:
                    raise AssertionError(f"cli eval: episodes {sorted(per_ep)}")
                for k, m in per_ep.items():
                    _finite_metrics(f"eval episode {k}", m)
                _finite_metrics("eval aggregate", agg)
                if seen["eval"] != ([("SyntheticRoomFeed", 336, 256)] * 6
                                    + [("FloorplanFeed", 336, 256)] * 2):
                    raise AssertionError(f"cli eval: feeds {seen['eval']}")
                log(f"[cli] eval steps {[int(m['steps_taken']) for m in per_ep.values()]} "
                    f"aggregate {json.dumps(agg)}")
            elif name == "inference":
                preds = json.load(open("data/eval/smoke_preds.json"))
                if sorted(preds) != ["0", "1", "2", "3"] or not all(preds.values()):
                    raise AssertionError(f"cli inference: {preds}")
                log(f"[cli] inference poses {[len(p) for p in preds.values()]}")
            elif name == "train_Dynam3D":
                names = os.listdir("data/checkpoints")
                if names != ["ckpt.iter1"]:
                    raise AssertionError(f"cli train: checkpoints {names}")
                size = os.path.getsize("data/checkpoints/ckpt.iter1") / 2**30
                log(f"[cli] train wrote {names} ({size:.2f} GiB)")
            elif name == "train_SS-ETP":
                rows = [json.loads(r) for r in open("data/logs/pre/scalars.jsonl")]
                losses = {r["step"]: r["value"] for r in rows if r["tag"] == "loss/loss"}
                if (sorted(losses) != [0, 1]
                        or not all(math.isfinite(r["value"]) for r in rows)):
                    raise AssertionError(f"cli SS-ETP: logged {rows}")
                if counts["nerf_mlp"] <= 0:
                    raise AssertionError("cli SS-ETP: kernel nerf_mlp was not launched")
                log(f"[cli] SS-ETP losses {json.dumps(losses)}, {len(rows)} scalars")
            else:
                rep = json.load(open("soak/soak_report.json"))
                per_ep = json.load(open("soak/stats_ep_soak_r0_w1.json"))
                if rep != json.loads(json.dumps(out)) or rep["steps"] != 100 or any(
                        m["steps_taken"] != 50.0 for m in per_ep.values()):
                    raise AssertionError(f"cli soak: report {rep}, episodes {per_ep}")
                for k, m in per_ep.items():
                    _finite_metrics(f"soak episode {k}", m)
                _finite_metrics("soak aggregate", rep["metrics"])
                if counts["int4_matvec"] <= 0 or counts["decode_attn"] <= 0:
                    raise AssertionError("cli soak: kernels A and B did not both launch")
                log(f"[cli] soak s_per_episode={rep['s_per_episode']:.3f} "
                    f"ms_per_step={rep['ms_per_step']:.1f} over {rep['steps']} steps, "
                    f"device {rep['device']}")
    finally:
        vln_loop.evaluate = evaluate
        os.chdir(cwd)
        tmp.cleanup()
    ctx["cli_launches"] = {k: windows["soak"][k] + windows["train_SS-ETP"][k]
                           for k in ("int4_matvec", "decode_attn", "nerf_mlp")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dynam3d_torch  # noqa: F401  (fails outside a checkout of the repo)
    from dynam3d_torch.device import pin_full_fp32

    pin_full_fp32()
    card = card_line()
    log(card)
    ctx = {"torch": torch, "card": card, "launches": {},
           "gen": torch.Generator(device="cuda").manual_seed(1234),
           "timer": Timer(torch)}
    for name in phases:
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](ctx)
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")

    kernels_rec = []
    if "matvec" in ctx:
        m = ctx["matvec"]
        kernels_rec.append(dict(
            name="int4_matvec", route="cuda", source="dynam3d_torch/csrc/int4_matvec.cu",
            replaces="dynam3d_tpu/ops/pallas_int4.py:212",
            launches=ctx["launches"].get("int4_matvec", 0),
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by="bytes", library_ms=m["library_ms"],
            work="qkv+o+gate_up+down of one decode layer at 8 rows"))
    if "ring" in ctx:
        r = ctx["ring"]
        kernels_rec.append(dict(
            name="decode_attn", route="cuda", source="dynam3d_torch/csrc/decode_attn.cu",
            replaces="dynam3d_tpu/ops/pallas_decode.py:927",
            launches=ctx["launches"].get("decode_attn", 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            work="shared-cache verify, 8 rows, Tmax 1024"))
    if "vln_launches" in ctx:
        # eval + inference launches, only when the vln phase ran
        for rec in kernels_rec:
            if rec["name"] in ctx["vln_launches"]:
                rec["launches_vln"] = ctx["vln_launches"][rec["name"]]
    pre = ctx.get("pretrain_launches", {})
    cli = ctx.get("cli_launches", {})
    walk = ctx.get("walk_launches", {})
    if "nerf" in ctx:
        r = ctx["nerf"]
        kernels_rec.append(dict(
            name="nerf_mlp", route="cuda", source="dynam3d_torch/csrc/nerf_mlp.cu",
            replaces="dynam3d_tpu/ops/pallas_mlp.py:50", launches=pre.get("nerf_mlp", 0),
            max_abs_err=r["max_abs_err"], ms=r["ms_cached_weights"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            work="one novel view: N=1152 rows, D=768, weights cached"))
        if "nerf_mlp" in walk:
            kernels_rec[-1]["launches_walk"] = walk["nerf_mlp"]
    if "knn" in ctx:
        r = ctx["knn"]
        kernels_rec.append(dict(
            name="knn_topk", route="cuda", source="dynam3d_torch/csrc/knn_topk.cu",
            replaces="dynam3d_tpu/ops/pallas_knn.py:92", launches=pre.get("knn_topk", 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            work="render stage 1: Q=72144, P=32768 (20160 live), k=4; bound over live pairs"))
        if "knn_topk" in walk:
            kernels_rec[-1]["launches_walk"] = walk["knn_topk"]
    bat = ctx.get("batched_launches", {})
    new = [("int4_matvec2d", ctx.get("matvec2d"), "int4_matvec2d.cu", "pallas_int4.py:283",
            "qkv 3072x9216 at 8 rows"),
           ("int4_mlp", ctx.get("mlp", {}).get("int4_mlp"), "int4_mlp.cu", "pallas_int4.py:387",
            "Phi-3-mini MLP (3072, 8192) at 12 rows"),
           ("int4_mlp_block", ctx.get("mlp", {}).get("int4_mlp_block"), "int4_mlp.cu",
            "pallas_int4.py:559", "Phi-3-mini MLP block at 1 row"),
           ("decode_attn_layer", ctx.get("attn"), "decode_attn_layer.cu", "pallas_decode.py:368",
            "Phi-3-mini attention half, Tmax 1024, write slot 900")]
    for name, r, src, rep_, work in new:
        if r is not None:
            kernels_rec.append(dict(
                name=name, route="cuda", source=f"dynam3d_torch/csrc/{src}",
                replaces=f"dynam3d_tpu/ops/{rep_}", launches=bat.get(name, 0),
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                work=work))
    tools = [("int4_stream_matvec", "tools/bench_int4_stream.py:95",
              "4 weights of 3072x16384 at S=2, nblk=512, 8 rows"),
             ("int4_unpack_matvec", "tools/bench_int4_unpack.py:174",
              "andtrick body, 4 weights of 3072x16384, 8 rows")]
    for name, rep_, work in tools:
        r = ctx.get("stream", {}).get(name)
        if r is not None:
            kernels_rec.append(dict(
                name=name, route="cuda", source="dynam3d_torch/csrc/int4_stream.cu",
                replaces=rep_, launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=r["library_ms"], work=work))
    for rec in kernels_rec:
        if rec["name"] in cli:
            rec["launches_cli"] = cli[rec["name"]]
    print(json.dumps({"kernels": kernels_rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
