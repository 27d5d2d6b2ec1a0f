#!/usr/bin/env python3
"""Drive the PyTorch port (``dynam3d_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases build,matvec,ring
    python3 chip_smoke.py --phases build,nerf,knn,render,pretrain
    python3 chip_smoke.py --phases build,mlp,attn,matvec2d,routes,batched
    python3 chip_smoke.py --phases build,yolo,stream
    python3 chip_smoke.py --phases build,vln
    python3 chip_smoke.py --phases build,walk
    python3 chip_smoke.py --phases build,convert
    python3 chip_smoke.py --phases build,data
    python3 chip_smoke.py --phases build,dist,soak
    python3 chip_smoke.py --phases build,tools

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
17. ``tools``: the profiling and A/B tools of ``dynam3d_torch/tools/`` on
   the serving parameters (the default config, int4 Phi-3-mini), each in a
   window with the launch counters reset just before and read just after
   and its JSON lines printed: ``prof_decode_parts`` (A, B, F, G, H; the
   fused and unfused one-step logits within ``LOGITS_TOL`` of their scale,
   the argmax equal unless the top-2 margin is under ``TIE_TOL`` of it),
   ``ab_fused_decode`` at B = 1 (A, B, F, G, H) and 4 (A, B, F), each fused
   route's logits and ids against the unfused route's, ``ab_spec_decode``
   (A, B; planted-continuation ids equal plain greedy's, force-accept
   emits the drafts in ceil((n - 1) / k) passes, with and without a
   lookup), ``ab_spec_batched`` (A, B; no-lookup rows equal plain batched
   greedy's), ``prof_prefill`` (A at the last position), ``bench_int8_prefill``,
   ``profile_perceive`` and ``prof_full_step`` (A, B: the B = 1 step's
   slope, device busy time and idle share); a difference of ids is allowed
   only at a near-tie, and no plain version may run;
18. ``yolo``: one full-width ``segment_views`` (FastSAM-x, imgsz 576) of a
   ``SyntheticRoomFeed`` view on the card and, with the same weights, on the
   CPU: ``forward`` within the stated tolerance, the same NMS picks and ids,
   ms per view, and the launches of the NMS loop;
19. ``stream``: kernels I and J (``csrc/int4_stream.cu``) against their plain
   versions at the int4 tools' shapes (4 weights of 3072 x 16384), every
   ring variant of I and every body of J, each with its work items, blocks
   per SM, dynamic shared memory and share of the bytes bound, then both
   tools' sweeps (``dynam3d_torch.tools.bench_int4_stream`` /
   ``bench_int4_unpack``) with the launch counters reset just before and
   read just after, the bytes bound and a bf16 ``torch.matmul`` on the
   dequantized weights as the yardstick;
20. ``vln``: the VLN second stage at full width — policy parameters with
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
21. ``cli``: the port as a user starts it, at the default ``Dynam3DConfig()``
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
   after (A and B in the soak, C in SS-ETP, no plain version anywhere);
22. ``convert``: the reference-weights runway at ``parity_run``'s ``full``
   config (the soak's: the default with member caps 512 / 128, 32-layer
   Phi-3-mini):
   truth trees on the card from seed 11 (policy, renderer, waypoint
   predictor, ResNet-50 depth encoder), ``synth_sd.synth_all`` of them, the
   ``dynam3d``, ``pretrain``, ``clip``, ``llava``, ``fastsam``, ``waypoint``
   and ``ddppo`` assets written as ``.pth`` files in a temporary directory
   (it fails if the disk there cannot hold them),
   ``tools.convert_reference_ckpt.main`` over them, the checkpoint read
   back to the card and every family held against the truth exactly (the
   HF tower's identity tail aside); ``tools.parity_run --converted``, 4
   steps with the logits dump, whose ids must equal those of the same 4
   steps on the int4-quantized truth; one view rendered with the converted
   renderer, kernel C held against its plain version on the inputs it got;
   ``tools.eval_soak --converted``, one ``train.max_traj_len`` episode;
   bytes and seconds of each step, peak memory, and the launch counters
   reset just before each counted step and read just after (A and B in the
   episodes and the soak, C in the render, no plain version);
23. ``data``: the reference's on-disk data path at the default config
   (CLIP-L/14-336, the default fields and renderer), in a temporary
   directory: 2 scenes of 24 frames in each of the four posed-frame layouts
   with their own formats (ScanNet at the 320x240 its halved
   ``intrinsic_depth.txt`` implies, two ``-inf`` poses; 3RScan 960x540 JPEG
   color and 224x172 ``.pgm`` depth; ARKitScenes ``lowres_wide`` 256x192
   with 3- and 4-digit timestamps, a pincam 1 ms off and one traj row
   dropped; Structured3D 1280x720), uint16 millimetre depth ray-cast in a
   box room, and per scene a SceneVerse cloud of 100,000 points with
   instance labels and captions; category embeddings from the CLIP text
   tower written and read back as ``category_embeddings.pth``;
   ``PretrainRunner.run`` over ``[ScanNetScenes, RScanScenes, ARKitScenes,
   Structured3DScenes]`` with each sample's ``build_language_supervision``
   (captions through the text tower), 4 iterations (a runner seed whose
   draws take each corpus once) and 1 under the k-NN gates, each printing
   its load (decode and supervision), build and step ms, peak memory,
   finite losses and its launch counters reset just before and read just
   after (C in every iteration, D in the gated one, no plain version), then
   one profiled ScanNet iteration; one render of the trained renderer with kernel C held against its plain
   version on the inputs it got; a ``discrete_to_ce`` conversion of a
   generated MatterSim graph of 3 scans x 60 viewpoints and 300 items, read
   back by ``load_episodes``; ``collect_trajectories`` of 2
   ``FloorplanFeed`` episodes into the port's episode store, replayed by
   ``iterate_store``; each timed;
24. ``dist``: the parallel layer on two ``gloo`` ranks sharing the card (NCCL
   refuses two ranks on one device), each spawned and joined with a time
   limit, printing its wall time, peak memory and launch counters: (1) a
   dp = 2 IL step at the default config (bf16 Phi-3-mini, one 12-view room
   step a rank through ``VLNTrainer``): finite loss, bit-identical
   trainable trees on both ranks, the gradient all-reduce's share of the
   step; the small config's dp = 2 step against one process on the same two
   rows within the CPU test's tolerances; (2) a dp = 2 pretraining step at
   full width, kernel C on every render of each rank, identical
   parameters; (3) ``run.main`` at ``WORLD_SIZE = 2`` (``Dynam3D``, one
   iteration, 1 step on rank 0 and 2 on rank 1), rank 0's checkpoint read
   back equal to the ranks' trees; (4) TP = 2 greedy decode of 20 tokens at
   Phi-3-mini width in float32 against one process's ids (a difference is
   allowed only where that process's top-2 margin is under 1e-4 of the
   logits' scale), two all-reduces a layer a pass; (5) rank-sharded int4
   ``evaluate`` (2 rooms of 3 steps a rank) merged by
   ``gather_list_and_concat``, equal to one process's over the same 4
   rooms, kernels A and B on each rank; (6) ``run.main`` for SS-ETP at
   ``WORLD_SIZE = 2`` (``train.seed`` 6: a walk of at most 2 steps, then an
   unposed frames iteration): both ranks draw the same datasets, kernel C
   on every render of each rank, the trained trees bit-identical after
   each iteration; (7) ``run.main`` for eval (8 episodes) and inference (4)
   at ``WORLD_SIZE = 2`` on int4 weights (``init_policy_params`` wrapped to
   pack Phi-3), A and B on each rank, rank 0's merged ``stats_ckpt.json``
   and ``_preds.json`` equal to one process's over the same feeds; then
   the IL step on a one-rank NCCL group;
25. ``soak``: ``python -m dynam3d_torch.tools.train_soak --scale full
   --il-steps 8 --pretrain-iters 4`` in a temporary work directory: every
   row, finite losses, both resume checks bit-compatible (the IL one in its
   fresh process), kernel C in every pretraining iteration and no plain
   version.

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
          "walk", "matvec2d", "mlp", "attn", "routes", "batched", "tools", "yolo", "stream",
          "vln", "cli", "convert", "data", "dist", "soak")

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
        ms = {f"{k[:-2]}_ms": v * 1e3 for k, v in t.items()}
        log(f"[pretrain] iter {i} {'posed' if i >= 2 else 'unposed'} {json.dumps(dict(m, **ms))}")
        if m["skipped"] or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"pretraining iteration {i}: {m}")
    after = tree_leaves({k: runner.params[k] for k in ("fields", "render")})
    moved = sum((a.float() - b.float()).abs().sum().item() for a, b in zip(after, before))
    if not moved > 0:
        raise AssertionError("pretraining left the parameters where they were")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pretrain] params_moved_l1={moved:.6g} peak_mem_gib={peak:.2f}")
    ctx["pretrain_launches"] = counts
    steady = sum(runner.timings[1].values())
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


def _tree_exact(label, got, want):
    """Two trees with the same structure, dtypes, shapes and values, bit
    for bit (max abs diff 0)."""
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"convert {label}: keys differ")
        for k in want:
            _tree_exact(f"{label}/{k}", got[k], want[k])
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"convert {label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_exact(f"{label}/{i}", g, w)
    elif not (got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)):
        raise AssertionError(f"convert {label}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}, max abs diff "
                             f"{(got.float() - want.float()).abs().max().item()}")


CONVERT_ASSETS = ("dynam3d", "pretrain", "clip", "llava", "fastsam", "waypoint", "ddppo")


def phase_convert(ctx):
    """The reference-weights runway at full width: reference-format state
    dicts synthesized from a truth tree, written as ``.pth`` files, converted
    by the CLI, checked exactly, then a parity run, a render and a soak on
    the converted checkpoint, each counted window's launches read."""
    torch = ctx["torch"]
    import dataclasses
    import gc
    import shutil
    import tempfile

    from dynam3d_torch.models import policy
    from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
    from dynam3d_torch.models.render import nerf
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3
    from dynam3d_torch.models.waypoint.trm import init_waypoint_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_cuda, nerf_mlp_plain
    from dynam3d_torch.runtime import synth_sd
    from dynam3d_torch.runtime.checkpoint import load_to_device
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.tools import convert_reference_ckpt, eval_soak, parity_run
    from dynam3d_torch.utils.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        return out

    def counted(label, fn, want=()):
        kernels.reset_counts()
        out = timed(label, fn)
        counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
        log(f"[convert] {label}: launches {json.dumps({k: v for k, v in counts.items() if v})} "
            f"plain calls {json.dumps({k: v for k, v in plain.items() if v})}")
        if any(plain.values()):
            raise AssertionError(f"convert {label}: plain kernel versions ran: {plain}")
        if any(counts[k] <= 0 for k in want):
            raise AssertionError(f"convert {label}: kernels {want} not all launched")
        for k in total:
            total[k] += counts[k]
        return out

    cfg = eval_soak.soak_config("full")
    secs, total = {}, {k: 0 for k in kernels.KERNELS}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="dynam3d_convert_")
    try:
        # 1-2. the truth trees from seed 11 (the converter's random base is
        # seed 0, so a family left unconverted cannot pass), then every asset
        gen = torch.Generator(device="cuda").manual_seed(11)
        truth = timed("truth", lambda: {
            "params": policy.init_policy_params(gen, cfg, device="cuda"),
            "render": nerf.init_render_params(gen, cfg.fields, "cuda"),
            "waypoint": init_waypoint_params(gen, cfg.waypoint, feature_dim(cfg.depth),
                                             device="cuda"),
            "depth_enc": init_depth_params(gen, cfg.depth, device="cuda")})
        sds = timed("synth", lambda: synth_sd.synth_all(
            truth["params"], cfg, render_params=truth["render"],
            waypoint_params=truth["waypoint"], depth_params=truth["depth_enc"]))
        need = sum(nbytes(sds[n]) for n in CONVERT_ASSETS) + nbytes(truth)
        free = shutil.disk_usage(tmp).free
        log(f"[convert] truth {nbytes(truth) / 2**30:.2f} GiB, assets "
            f"{ {n: len(sds[n]) for n in sds} } in {tmp} ({free / 2**30:.1f} GiB free)")
        if free < 1.1 * need:
            raise AssertionError(f"convert: {free / 2**30:.1f} GiB free under {tmp}, the assets "
                                 f"and the converted checkpoint need {need / 2**30:.1f} GiB")

        # 3. the assets as .pth files
        paths = {n: os.path.join(tmp, f"{n}.pth") for n in CONVERT_ASSETS}

        def write():
            for n in CONVERT_ASSETS:
                torch.save(sds[n], paths[n])

        timed("write", write)
        written = sum(os.path.getsize(p) for p in paths.values())
        del sds
        gc.collect()
        torch.cuda.empty_cache()

        # 4. the conversion CLI over the files, at the phase's config (the
        # waypoint NMS sigmas, a tuple JSON cannot hold, keep their default)
        conf = dataclasses.asdict(cfg)
        conf["waypoint"].pop("nms_sigma")
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(conf, f)
        argv = ["--out", os.path.join(tmp, "converted"), "--exp-config",
                os.path.join(tmp, "config.json")]
        for n in CONVERT_ASSETS:
            argv += [f"--{n}", paths[n]]
        out = timed("convert", lambda: convert_reference_ckpt.main(argv))
        ckpt = out["path"]
        ckpt_bytes = os.path.getsize(ckpt)
        want_report = {"fields": "pretrain", "render": "pretrain", "clip": "clip",
                       "llava": "llava", "yolo": "fastsam", "waypoint": "waypoint",
                       "depth_enc": "ddppo"}
        if out["report"] != want_report:
            raise AssertionError(f"convert: report {out['report']}")

        # 5. every family against the truth, exactly (the HF tower's identity
        # tail aside); what no asset here carries (the five projectors, the
        # LLaVA tower's unused text half) is the converter's seed-0 base and
        # goes into the truth for step 7
        loaded = timed("load", lambda: load_to_device(ckpt))
        got = loaded["params"]
        truth["params"]["llava"]["clip"]["text"] = got["llava"]["clip"]["text"]
        for part in ("patch_pos_emb", "inst_pos_emb", "zone_pos_emb", "inst_proj", "zone_proj"):
            truth["params"][part] = got[part]
        for part in ("fields", "clip", "yolo"):
            _tree_exact(part, got[part], truth["params"][part])
        _tree_exact("llava", got["llava"],
                    parity_run.with_identity_tail(truth["params"]["llava"], got["llava"]))
        for part in ("render", "waypoint", "depth_enc"):
            _tree_exact(part, loaded[part], truth[part])
        render = loaded["render"]
        del loaded, got
        gc.collect()
        torch.cuda.empty_cache()
        secs["cli_convert"], secs["cli_save"] = out["convert_s"], out["save_s"]
        log(f"[convert] every family exact; wrote {written / 2**30:.3f} GiB of assets in "
            f"{secs['write']:.2f} s ({written / secs['write'] / 2**30:.3f} GiB/s), the CLI "
            f"{secs['convert']:.2f} s (reading and converting {out['convert_s']:.2f} s, saving "
            f"the {ckpt_bytes / 2**30:.3f} GiB checkpoint {out['save_s']:.2f} s), read it back "
            f"to the card in {secs['load']:.2f} s ({ckpt_bytes / secs['load'] / 2**30:.3f} GiB/s)")

        # 6. the parity run on the converted checkpoint
        rep = counted("parity_run", lambda: parity_run.main(
            ["--out", os.path.join(tmp, "parity"), "--converted", ckpt, "--steps", "4",
             "--dump-logits"]), want=("int4_matvec", "decode_attn"))
        steps = [json.loads(r) for r in open(os.path.join(tmp, "parity", "steps_parity.jsonl"))]
        if (len(steps) != rep["steps"] or len(steps[0]["logits_top10"]) != 10
                or not all(math.isfinite(v) for v in rep["metrics"].values())):
            raise AssertionError(f"convert parity_run: report {rep}")
        log(f"[convert] parity_run steps={rep['steps']} step_s="
            f"{[round(s['step_s'], 4) for s in steps]} padded="
            f"{[s['prompt_padded_len'] for s in steps]} logits_top10[0]="
            f"{next(iter(steps[0]['logits_top10'].items()))}")

        # 7. the same steps on the int4-quantized truth: the same bits, so
        # the same ids
        truth["params"]["llava"]["phi3"] = quantize_phi3(truth["params"]["llava"]["phi3"],
                                                         bits=4, consume=True)
        os.makedirs(os.path.join(tmp, "truth"))
        counted("truth_episode", lambda: parity_run.run_episode(
            truth["params"], cfg, SyntheticRoomFeed(rgb_size=cfg.clip.image_size,
                                                    depth_size=256, views=1),
            os.path.join(tmp, "truth"), 4), want=("int4_matvec", "decode_attn"))
        ref = [json.loads(r) for r in open(os.path.join(tmp, "truth", "steps_parity.jsonl"))]
        if [s["action_ids"] for s in steps] != [s["action_ids"] for s in ref]:
            raise AssertionError("convert: the converted weights decode other ids than the truth")
        del truth
        gc.collect()
        torch.cuda.empty_cache()

        # 8. one view with the converted renderer; kernel C against its plain
        # version on the inputs it got (outside the counted window)
        fcfg = cfg.fields
        state = _render_state(torch, fcfg)
        seen = []
        real = nerf.fused_nerf_mlp

        def recording(x, *w):
            seen.append((x, w))
            return real(x, *w)

        nerf.fused_nerf_mlp = recording
        try:
            with torch.no_grad():
                view = counted("render", lambda: nerf.render_view(
                    render, fcfg, state, torch.tensor([0.3, -0.2, 1.25], device="cuda"),
                    torch.tensor(0.7, device="cuda")), want=("nerf_mlp",))
        finally:
            nerf.fused_nerf_mlp = real
        if not seen or not all(bool(torch.isfinite(t.float()).all()) for t in view):
            raise AssertionError("convert render: kernel C did not run or the view is not finite")
        c_err, c_tol = 0.0, 0.0
        for x, w in seen:
            ok, dk = nerf_mlp_cuda(x, *w)
            op, dp = nerf_mlp_plain(x, *w)
            c_tol = max(c_tol, _bf16_tol(op), _bf16_tol(dp))
            c_err = max(c_err, (ok.float() - op.float()).abs().max().item(),
                        (dk.float() - dp.float()).abs().max().item())
        if not c_err <= c_tol:
            raise AssertionError(f"convert render: kernel C err {c_err} > {c_tol}")
        log(f"[convert] render N={seen[0][0].shape[0]} kernel C vs plain max_abs_err={c_err} "
            f"(tol {c_tol})")

        # 9. the eval soak on the converted checkpoint, one full episode
        soak = counted("soak", lambda: eval_soak.main(
            ["--out", os.path.join(tmp, "soak"), "--episodes", "1", "--converted", ckpt]),
            want=("int4_matvec", "decode_attn"))
        if (soak["weights"] != ckpt or soak["steps"] != cfg.train.max_traj_len
                or not all(math.isfinite(v) for v in soak["metrics"].values())):
            raise AssertionError(f"convert soak: report {soak}")
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10. A and B on the episodes, C on the render, no plain version
    for k in ("int4_matvec", "decode_attn", "nerf_mlp"):
        if total[k] <= 0:
            raise AssertionError(f"convert: kernel {k} was not launched")
    row = dict(seconds=secs, bytes_written=written, checkpoint_bytes=ckpt_bytes,
               write_gib_s=written / secs["write"] / 2**30,
               read_gib_s=ckpt_bytes / secs["load"] / 2**30,
               parity_steady_step_ms=rep["steady_step_ms"], parity_first_step_s=rep["first_step_s"],
               soak_ms_per_step=soak["ms_per_step"], kernel_c_max_abs_err=c_err,
               peak_mem_gib=peak, launches={k: v for k, v in total.items() if v})
    log(f"[convert] {json.dumps(row)}")
    ctx["convert_launches"] = {k: total[k] for k in ("int4_matvec", "decode_attn", "nerf_mlp")}


# ---------------------------------------------------------------------------
# the data phase: posed-frame corpora in the reference's on-disk layouts
# ---------------------------------------------------------------------------
ROOM = (6.4, 5.2, 2.7)                  # the box room's x, y, z extents, metres
SCENE_CATEGORIES = ("floor", "ceiling", "wall", "door", "window", "chair", "table", "sofa",
                    "bed", "cabinet", "shelf", "lamp", "plant", "picture", "counter", "sink",
                    "trash_can", "office chair", "tv/monitor", "book|shelf")


def _look_rot(yaw: float, pitch: float):
    """Camera-to-world rotation of a camera looking at ``yaw`` about world
    z (up), ``pitch`` below the horizon: columns right, down, forward."""
    import numpy as np

    f = np.asarray([math.cos(pitch) * math.cos(yaw), math.cos(pitch) * math.sin(yaw),
                    -math.sin(pitch)])
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    return np.stack([r, np.cross(f, r), f], axis=1)


def _room_view(k, rot, trans, h: int, w: int):
    """Ray-cast the box room from a pinhole camera (pixel ``(u, v)`` looks
    along ``((u - cx) / fx, (v - cy) / fy, 1)``): z-depth in metres and a
    checker texture of the hit points, ``(depth [h, w], rgb u8 [h, w, 3])``."""
    import numpy as np

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d = np.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1], np.ones_like(u)], -1)
    dw = d @ np.asarray(rot).T
    hi = np.asarray(ROOM)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(dw > 0, (hi - trans) / dw, np.where(dw < 0, -trans / dw, np.inf))
    z = t.min(-1)
    hit = trans + z[..., None] * dw
    face = t.argmin(-1) * 2 + (np.take_along_axis(dw, t.argmin(-1)[..., None], -1)[..., 0] > 0)
    checker = (np.floor(hit * 2.5).sum(-1) % 2)[..., None]
    tint = np.asarray([[200, 90, 60], [60, 170, 90], [70, 90, 210], [190, 180, 70],
                       [150, 150, 150], [120, 60, 160]], np.float64)[face]
    rgb = np.clip(tint * (0.55 + 0.45 * checker), 0, 255).astype(np.uint8)
    return z, rgb


def _depth_mm(z, rng, holes: float = 0.01):
    """Metres -> uint16 millimetres, with a share of zero (no return) pixels."""
    import numpy as np

    mm = np.clip(np.rint(z * 1000.0), 0, 65535).astype(np.uint16)
    mm[rng.random(mm.shape) < holes] = 0
    return mm


def _camera_poses(rng, n: int):
    """``n`` camera-to-world poses inside the room: (rot, trans)."""
    import numpy as np

    out = []
    for _ in range(n):
        trans = np.asarray([rng.uniform(0.8, ROOM[0] - 0.8), rng.uniform(0.8, ROOM[1] - 0.8),
                            rng.uniform(1.1, 1.7)])
        out.append((_look_rot(rng.uniform(-math.pi, math.pi), rng.uniform(-0.15, 0.35)), trans))
    return out


def _save_png(path, arr) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _save_mat(path, m) -> None:
    with open(path, "w") as f:
        for row in m:
            f.write(" ".join(repr(float(x)) for x in row) + "\n")


def _axis_angle(r):
    """Rotation matrix -> axis-angle vector (the ARKit traj's w2c rotation)."""
    import numpy as np

    theta = math.acos(max(-1.0, min(1.0, (np.trace(r) - 1.0) / 2.0)))
    if theta < 1e-12:
        return np.zeros(3)
    axis = np.asarray([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return axis / (2.0 * math.sin(theta)) * theta


def write_scannet(root: str, scene: str, frames: int, seed: int, size=(240, 320),
                  lost=(3, 11)) -> None:
    """ScanNet ``frames_square``: ``intrinsic_depth.txt`` of the 640x480
    sensor (the loader halves it to ``size``), JPEG color and uint16 PNG
    depth at ``size``, 4x4 camera-to-world poses, ``-inf`` poses at the
    tracking-lost frames ``lost``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = size
    base = os.path.join(root, scene)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, sub))
    k_full = np.eye(4)
    k_full[0, 0], k_full[1, 1], k_full[0, 2], k_full[1, 2] = (
        577.87 * 2 * w / 640, 577.87 * 2 * h / 480, w - 0.5, h - 0.5)
    _save_mat(os.path.join(base, "intrinsic_depth.txt"), k_full)
    k = k_full[:3, :3] / 2.0
    k[2, 2] = 1.0
    from PIL import Image

    for i, (rot, trans) in enumerate(_camera_poses(rng, frames)):
        z, rgb = _room_view(k, rot, trans, h, w)
        Image.fromarray(rgb).save(os.path.join(base, "color", f"{i}.jpg"), quality=90)
        _save_png(os.path.join(base, "depth", f"{i}.png"), _depth_mm(z, rng))
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = rot, trans
        _save_mat(os.path.join(base, "pose", f"{i}.txt"),
                  np.full((4, 4), -np.inf) if i in lost else pose)


def write_rscan(root: str, scene: str, frames: int, seed: int, color=(540, 960),
                depth=(172, 224)) -> None:
    """3RScan ``sequence/``: ``_info.txt`` with the depth intrinsics on line
    9, ``frame-XXXXXX.color.jpg`` at ``color``, ``.depth.pgm`` (uint16 mm)
    at ``depth``, ``.pose.txt`` camera-to-world."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    seq = os.path.join(root, scene, "sequence")
    os.makedirs(seq)
    (ch, cw), (dh, dw) = color, depth
    kc = np.asarray([[0.78 * cw, 0, cw / 2 - 0.3], [0, 0.78 * cw, ch / 2 + 0.2], [0, 0, 1]])
    kd = np.asarray([[0.79 * dw, 0, dw / 2 + 0.4], [0, 0.79 * dw, dh / 2 - 0.1], [0, 0, 1]])

    def k4(k):
        m = np.eye(4)
        m[:3, :3] = k
        return " ".join(repr(float(x)) for x in m.reshape(-1))

    lines = ["m_versionNumber = 4", "m_sensorName = StructureSensor", f"m_colorWidth = {cw}",
             f"m_colorHeight = {ch}", f"m_depthWidth = {dw}", f"m_depthHeight = {dh}",
             "m_depthShift = 1000", f"m_calibrationColorIntrinsic = {k4(kc)}",
             f"m_calibrationColorExtrinsic = {k4(np.eye(3))}",
             f"m_calibrationDepthIntrinsic = {k4(kd)}",
             f"m_calibrationDepthExtrinsic = {k4(np.eye(3))}", f"m_frames.size = {frames}"]
    with open(os.path.join(seq, "_info.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for i, (rot, trans) in enumerate(_camera_poses(rng, frames)):
        stem = os.path.join(seq, f"frame-{i:06d}")
        _, rgb = _room_view(kc, rot, trans, ch, cw)
        Image.fromarray(rgb).save(stem + ".color.jpg", quality=90)
        z, _ = _room_view(kd, rot, trans, dh, dw)
        Image.fromarray(_depth_mm(z, rng)).save(stem + ".depth.pgm")
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = rot, trans
        _save_mat(stem + ".pose.txt", pose)


def write_arkit(root: str, scene: str, frames: int, seed: int, size=(192, 256),
                dropped: int = 5) -> None:
    """ARKitScenes ``lowres_wide`` at ``size``: ``<scene>_<ts>.png`` color and
    depth with timestamps of 3 and 4 integer digits (name order is not time
    order), one ``.pincam`` each (one named 1 ms off), and
    ``lowres_wide.traj`` rows of world-to-camera axis-angle and translation
    with the row of frame ``dropped`` missing."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames_dir = os.path.join(root, scene, f"{scene}_frames")
    for sub in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        os.makedirs(os.path.join(frames_dir, sub))
    h, w = size
    rows = []
    for i, (rot, trans) in enumerate(_camera_poses(rng, frames)):
        ts = f"{996.5 + 0.1 * i * (1 + 10 * (i % 3)):.3f}"
        k = np.asarray([[0.83 * w + i * 0.01, 0, w / 2 - 0.5], [0, 0.83 * w + i * 0.01, h / 2 + 0.5],
                        [0, 0, 1]])
        z, rgb = _room_view(k, rot, trans, h, w)
        _save_png(os.path.join(frames_dir, "lowres_wide", f"{scene}_{ts}.png"), rgb)
        _save_png(os.path.join(frames_dir, "lowres_depth", f"{scene}_{ts}.png"), _depth_mm(z, rng))
        pin_ts = f"{float(ts) + 0.001:.3f}" if i == 1 else ts
        with open(os.path.join(frames_dir, "lowres_wide_intrinsics",
                               f"{scene}_{pin_ts}.pincam"), "w") as f:
            f.write(" ".join(repr(float(x)) for x in (w, h, k[0, 0], k[1, 1], k[0, 2], k[1, 2]))
                    + "\n")
        if i != dropped:
            r_w2c = rot.T
            aa, t_w2c = _axis_angle(r_w2c), -r_w2c @ trans
            rows.append(" ".join([ts] + [repr(float(x)) for x in (*aa, *t_w2c)]))
    with open(os.path.join(frames_dir, "lowres_wide.traj"), "w") as f:
        f.write("\n".join(rows) + "\n")


def write_structured3d(root: str, scene: str, frames: int, seed: int, size=(720, 1280)) -> None:
    """Structured3D ``2D_rendering/<room>/perspective/full/<view>/``:
    ``rgb_rawlight.png``, uint16 ``depth.png`` (mm) and ``camera_pose.txt``
    (position in mm, look-at, up, half fovs), views spread over two rooms."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = size
    for i, (rot, trans) in enumerate(_camera_poses(rng, frames)):
        view = os.path.join(root, scene, "2D_rendering", str(485142 + i % 2), "perspective",
                            "full", str(i // 2))
        os.makedirs(view)
        xfov = 0.5 * math.radians(rng.uniform(80, 100))
        yfov = math.atan(math.tan(xfov) * h / w)
        k = np.asarray([[w / 2 / math.tan(xfov), 0, w / 2], [0, h / 2 / math.tan(yfov), h / 2],
                        [0, 0, 1]])
        z, rgb = _room_view(k, rot, trans, h, w)
        _save_png(os.path.join(view, "rgb_rawlight.png"), rgb)
        _save_png(os.path.join(view, "depth.png"), _depth_mm(z, rng))
        up = -rot[:, 1]
        row = [*(trans * 1000.0), *rot[:, 2], *up, xfov, yfov]
        with open(os.path.join(view, "camera_pose.txt"), "w") as f:
            f.write(" ".join(repr(float(x)) for x in row) + "\n")


def sceneverse_cloud(seed: int, n_points: int = 100_000, n_objects: int = 24):
    """A SceneVerse-style point cloud of the room: points on the six faces
    and on ``n_objects`` box-shaped objects, with instance ids (floor 1,
    ceiling 2, walls 3-6, objects from 7), RGB, and ``instance id ->
    label``: ``(xyz f32 [G, 3], rgb u8 [G, 3], inst i64 [G], labels)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_obj_pts = n_points // 3
    face = rng.integers(0, 6, n_points - n_obj_pts)
    xyz = rng.uniform(0, 1, (face.size, 3)) * ROOM
    axis = np.asarray([2, 2, 0, 0, 1, 1])[face]
    xyz[np.arange(face.size), axis] = np.where(face % 2, np.asarray(ROOM)[axis], 0.0)
    inst = np.asarray([1, 2, 3, 4, 5, 6])[face]
    extents = rng.uniform(0.2, 0.9, (n_objects, 3))
    centers = rng.uniform([0.5, 0.5, 0.0], [ROOM[0] - 0.5, ROOM[1] - 0.5, 0.8], (n_objects, 3))
    centers[:, 2] += extents[:, 2] / 2                   # standing on the floor
    obj = rng.integers(0, n_objects, n_obj_pts)
    pts = centers[obj] + (rng.uniform(-0.5, 0.5, (n_obj_pts, 3)) * extents[obj])
    xyz = np.concatenate([xyz, pts]).astype(np.float32)
    inst = np.concatenate([inst, 7 + obj]).astype(np.int64)
    rgb = rng.integers(0, 256, (xyz.shape[0], 3)).astype(np.uint8)
    labels = {1: "floor", 2: "ceiling", 3: "wall", 4: "wall", 5: "wall", 6: "wall"}
    for j in range(n_objects):
        labels[7 + j] = SCENE_CATEGORIES[3 + int(rng.integers(0, len(SCENE_CATEGORIES) - 3))]
    return xyz, rgb, inst, labels


def write_sceneverse(root: str, dataset: str, scenes, seed: int, n_points: int = 100_000,
                     align=None) -> None:
    """SceneVerse blobs of ``scenes`` under ``root``: the
    ``pcd_with_global_alignment/<scene>.pth`` tuple (ScanNet ``(xyz, rgb,
    semantic, instance)`` with xyz in the axis-aligned frame, ``align
    [scene] @ world``; 3RScan / ARKit ``(xyz, rgb, instance)``),
    ``instance_id_to_label/<scene>.pth`` and the captions
    ``3dff_<dataset>_annotations.json`` for half of each scene's
    instances."""
    import numpy as np
    import torch

    for sub in ("pcd_with_global_alignment", "instance_id_to_label"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ann = {}
    for s, scene in enumerate(scenes):
        xyz, rgb, inst, labels = sceneverse_cloud(seed + s, n_points)
        if dataset == "scannet":
            hom = np.concatenate([xyz, np.ones((xyz.shape[0], 1), np.float32)], 1)
            aligned = (hom @ np.asarray(align[scene], np.float32).T)[:, :3]
            blob = (aligned.astype(np.float32), rgb, inst % 40, inst)
        else:
            blob = (xyz, rgb, inst)
        torch.save(blob, os.path.join(root, "pcd_with_global_alignment", f"{scene}.pth"))
        torch.save(labels, os.path.join(root, "instance_id_to_label", f"{scene}.pth"))
        ann[scene] = {str(i): [[cat, f"the {cat.replace('_', ' ')} number {i} of {scene}"],
                               [cat, f"a {cat} by the wall"]]
                      for i, cat in labels.items() if i % 2}
    with open(os.path.join(root, f"3dff_{dataset}_annotations.json"), "w") as f:
        json.dump(ann, f)


def align_matrices(scenes, seed: int):
    """ScanNet axis alignments: a turn about z and a shift per scene."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for scene in scenes:
        a = rng.uniform(-math.pi, math.pi)
        m = np.eye(4)
        m[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
        m[:3, 3] = rng.uniform(-3, 3, 3)
        out[scene] = m.tolist()
    return out


def write_corpora(root: str, frames: int, seed: int, scenes: int = 2, sizes=None,
                  n_points: int = 100_000):
    """The four corpora and their SceneVerse blobs under ``root``; ``sizes``
    overrides a layout's frame sizes (``{"scannet": {"size": (h, w)}}``).
    Returns each layout's root, SceneVerse root and scene ids."""
    sizes = sizes or {}
    names = {"scannet": [f"scene{700 + i:04d}_00" for i in range(scenes)],
             "rscan": [f"0cac75{i:02d}-8d6f-2d13-8c7e-b1f3c4d8a{i:03d}" for i in range(scenes)],
             "arkit": [str(41069042 + 17 * i) for i in range(scenes)],
             "structured3d": [f"scene_{3000 + i:05d}" for i in range(scenes)]}
    writers = {"scannet": write_scannet, "rscan": write_rscan, "arkit": write_arkit,
               "structured3d": write_structured3d}
    out = {}
    for d, (name, writer) in enumerate(writers.items()):
        data = os.path.join(root, name, "data")
        sv = os.path.join(root, name, "sceneverse")
        for s, scene in enumerate(names[name]):
            writer(data, scene, frames, seed + 100 * d + s, **sizes.get(name, {}))
        out[name] = {"root": data, "sceneverse": sv, "scenes": names[name]}
        if name == "scannet":
            align = align_matrices(names[name], seed)
            out[name]["align"] = os.path.join(root, name, "align.json")
            with open(out[name]["align"], "w") as f:
                json.dump(align, f)
        if name != "structured3d":
            write_sceneverse(sv, name, names[name], seed + 10 * d, n_points,
                             align if name == "scannet" else None)
    return out


class _Supervised:
    """A scene dataset whose samples carry their language supervision
    (``build_language_supervision`` of the scene's SceneVerse captions and
    instance labels, captions through ``encode_text``) under the keys a
    frames iteration hands to ``build_batch``; ``times`` keeps the seconds
    of each sample's frame loading and of its supervision."""

    def __init__(self, ds, name, annotations, labels, cat_dict, cat_emb, encode_text, seed):
        import random

        from dynam3d_torch.runtime.scene_datasets import build_language_supervision

        self.ds, self.name, self.ann, self.labels = ds, name, annotations, labels
        self.cat_dict, self.cat_emb, self.encode_text = cat_dict, cat_emb, encode_text
        self.build = build_language_supervision
        self.rng = random.Random(seed)
        self.times = []

    def sample_scene(self):
        t0 = time.perf_counter()
        scene = self.ds.sample_scene()
        t1 = time.perf_counter()
        g2c, fts, valid = self.build(scene, self.ann, self.cat_dict, self.cat_emb,
                                     self.encode_text, self.labels.get(scene["scene_id"]),
                                     rng=self.rng)
        scene.update(cat_embeddings=self.cat_emb, gtid_to_cat=g2c, gtid_text_fts=fts)
        self.times.append({"decode_s": t1 - t0, "supervision_s": time.perf_counter() - t1,
                           "captioned": int(valid.sum())})
        return scene


def _mattersim_graph(conn_dir: str, scan: str, rng, n: int):
    """A MatterSim ``{scan}_connectivity.json``: ``n`` viewpoints on a
    serpentine through a building, 4x4 poses, a chain of unobstructed
    edges plus shortcuts, the last viewpoint not included; returns the
    viewpoint ids."""
    import numpy as np

    pos = np.stack([np.arange(n) % 8 * 1.7, np.arange(n) // 8 * 2.1, 1.5 + 0.01 * np.arange(n)],
                   1)
    pos[:, :2] += rng.normal(0, 0.2, (n, 2))
    adj = np.eye(n, k=1, dtype=bool) | np.eye(n, k=-1, dtype=bool)
    for a, b in rng.integers(0, n, (n // 3, 2)):
        if a != b and np.linalg.norm(pos[a] - pos[b]) < 4.0:
            adj[a, b] = adj[b, a] = True
    ids = [f"{scan[-6:]}{i:04x}{'0' * 24}" for i in range(n)]
    nodes = []
    for i in range(n):
        pose = np.eye(4)
        pose[:3, 3] = pos[i]
        nodes.append({"image_id": ids[i], "pose": pose.reshape(-1).tolist(),
                      "included": i != n - 1, "unobstructed": adj[i].tolist(), "height": 1.5})
    with open(os.path.join(conn_dir, f"{scan}_connectivity.json"), "w") as f:
        json.dump(nodes, f)
    return ids


def write_discrete_dataset(root: str, seed: int, viewpoints: int = 60, items: int = 300):
    """A discrete (MatterSim-graph) VLN dataset: ``connectivity/`` graphs of
    two HM3D-style scans and one MP3D scan, and ``items.json`` of walks on
    them (some through the excluded viewpoint, the last on a scan without a
    graph) with headings and one to three instructions (some long, some
    with a banned word), instruction encodings on every other item.
    Returns the two paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    conn = os.path.join(root, "connectivity")
    os.makedirs(conn)
    words = ("walk", "past", "the", "sofa", "into", "kitchen", "up", "stairs", "through", "door",
             "turn", "left", "right", "and", "stop", "at", "bedroom", "painting", "table")
    scans = ["00800-TEEsavR23oF", "00801-HaxA7YrQdEC", "17DRP5sb8fy"]
    ids = {scan: _mattersim_graph(conn, scan, rng, viewpoints) for scan in scans}
    out = []
    for i in range(items):
        scan = scans[i % len(scans)] if i != items - 1 else "00999-nographhere"
        vps = ids.get(scan, ["a", "b"])
        start = int(rng.integers(0, len(vps) - 1))
        path = vps[start:start + int(rng.integers(2, 8))]
        instr = [" ".join(rng.choice(words, int(rng.integers(4, 32))))
                 for _ in range(int(rng.integers(1, 4)))]
        item = {"scan": scan, "path": path, "heading": float(rng.uniform(0, 2 * math.pi)),
                "instructions": instr}
        if i % 2:
            item["instr_encodings"] = [rng.integers(0, 999, 5).tolist() for _ in instr]
        out.append(item)
    path = os.path.join(root, "items.json")
    with open(path, "w") as f:
        json.dump(out, f)
    return path, conn


def phase_data(ctx):
    """The reference's on-disk data path at full width: the four posed-frame
    corpora and their SceneVerse supervision through ``PretrainRunner.run``
    (4 iterations, one per corpus, then 1 under the k-NN gates), each
    iteration's launch counters reset just before and read just after, and
    one profiled iteration;
    kernel C against its plain version on a render of the trained renderer;
    then a ``discrete_to_ce`` conversion and a DAgger collection into the
    episode store, replayed."""
    torch = ctx["torch"]
    import shutil
    import tempfile

    from dynam3d_torch.config import Dynam3DConfig, SegmenterConfig
    from dynam3d_torch.models.encoders import clip as clip_mod
    from dynam3d_torch.models.encoders.clip_tokenizer import hash_tokenize
    from dynam3d_torch.models.memory3d import init_field_params
    from dynam3d_torch.models.render import nerf
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_cuda, nerf_mlp_plain
    from dynam3d_torch.runtime import dagger, datasets, scene_datasets as sd
    from dynam3d_torch.runtime.feed import FloorplanFeed
    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner
    from dynam3d_torch.runtime.trainer_3dff import draw_dataset_id
    from dynam3d_torch.tools import discrete_to_ce
    from dynam3d_torch.utils.tree import tree_leaves

    cfg = Dynam3DConfig(segmenter=SegmenterConfig(provider="depth_plane"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = {"fields": init_field_params(gen, cfg.fields, "cuda"),
              "render": nerf.init_render_params(gen, cfg.fields, "cuda"),
              "clip": clip_mod.init_clip_params(gen, cfg.clip, "cuda")}
    before = [t.clone() for t in tree_leaves({k: params[k] for k in ("fields", "render")})]
    tmp = tempfile.mkdtemp(prefix="dynam3d_data_")
    secs = {}
    try:
        # 1-2. the corpora and their SceneVerse blobs
        t0 = time.perf_counter()
        corp = write_corpora(os.path.join(tmp, "corpora"), frames=24, seed=7)
        secs["write_corpora"] = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
        log(f"[data] wrote 4 corpora x 2 scenes x 24 frames and SceneVerse blobs: "
            f"{nbytes / 2**20:.1f} MiB in {secs['write_corpora']:.1f} s")

        # 3. language supervision: category embeddings from the text tower,
        # written and read back as the reference's category_embeddings.pth
        cats = sorted({c.replace("_", " ").replace("|", " ").replace("/", " ")
                       for c in SCENE_CATEGORIES})

        def encode_text(texts):
            tokens = torch.from_numpy(hash_tokenize(list(texts), cfg.clip.text_context)).cuda()
            with torch.no_grad():
                return clip_mod.encode_text(params["clip"], cfg.clip, tokens).float().cpu().numpy()

        emb_path = os.path.join(tmp, "category_embeddings.pth")
        torch.save([{c: i for i, c in enumerate(cats)}, torch.from_numpy(encode_text(cats))],
                   emb_path)
        cat_dict, cat_emb = sd.load_category_embeddings(emb_path)
        if cat_emb.shape != (len(cats), cfg.fields.fts_dim):
            raise AssertionError(f"category embeddings {cat_emb.shape}")

        def layout(name, cls, **kw):
            c = corp[name]
            ann = labels = None
            if name != "structured3d":
                ann = sd.SceneVerseAnnotations(
                    os.path.join(c["sceneverse"], f"3dff_{name}_annotations.json"))
                labels = {s: sd.load_instance_labels(
                    [os.path.join(c["sceneverse"], "instance_id_to_label", f"{s}.pth")])
                    for s in c["scenes"]}
                kw.update(sceneverse_root=c["sceneverse"], annotations=ann)
            ds = cls(c["root"], frames=16, seed=len(name), **kw)
            return _Supervised(ds, name, ann, labels or {}, cat_dict, cat_emb, encode_text,
                               seed=len(name))

        corpora = [layout("scannet", sd.ScanNetScenes, align_matrix_json=corp["scannet"]["align"]),
                   layout("rscan", sd.RScanScenes), layout("arkit", sd.ARKitScenes),
                   layout("structured3d", sd.Structured3DScenes)]

        # 4. training: a seed whose first four draws take each corpus once
        seed = next(s for s in range(10_000)
                    if sorted(draw_dataset_id(s, i, 4) for i in range(4)) == [0, 1, 2, 3])
        runner = PretrainRunner(params, cfg, seed=seed, device="cuda")
        rows, total = [], {k: 0 for k in kernels.KERNELS}
        for it in range(5):
            gated = it == 4
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ds = corpora[draw_dataset_id(seed, runner.it, 4)]
            kernels.reset_counts()
            with _flags(KNN_FLAG_ENV) if gated else contextlib.nullcontext():
                m = runner.run(corpora, iters=1)[0]
            torch.cuda.synchronize()
            counts, plain = dict(kernels.launches), dict(kernels.plain_calls)
            t, h = runner.timings[-1], ds.times[-1]
            row = dict(iter=it, corpus=ds.name, knn_gates=gated, metrics=m,
                       load_ms=t["load_s"] * 1e3, decode_ms=h["decode_s"] * 1e3,
                       supervision_ms=h["supervision_s"] * 1e3, captioned=h["captioned"],
                       build_ms=t["build_s"] * 1e3, step_ms=t["step_s"] * 1e3,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                       finite=all(math.isfinite(v) for v in m.values()),
                       launches={k: v for k, v in counts.items() if v})
            log(f"[data] {json.dumps(row)}")
            rows.append(row)
            if any(plain.values()):
                raise AssertionError(f"data iter {it}: plain kernel versions ran: {plain}")
            if counts["nerf_mlp"] <= 0 or (gated and counts["knn_topk"] <= 0):
                raise AssertionError(f"data iter {it}: kernels not launched: {counts}")
            if not row["finite"] or m["skipped"]:
                raise AssertionError(f"data iter {it}: {m}")
            for k in total:
                total[k] += counts[k]
        if sorted(r["corpus"] for r in rows[:4]) != sorted(c.name for c in corpora):
            raise AssertionError(f"data: corpora drawn {[r['corpus'] for r in rows]}")
        after = tree_leaves({k: runner.params[k] for k in ("fields", "render")})
        moved = sum((a.float() - b.float()).abs().sum().item() for a, b in zip(after, before))
        if not moved > 0:
            raise AssertionError("data: pretraining left the parameters where they were")
        # 5. one profiled ScanNet iteration, outside the counted windows
        scannet = next(r for r in rows if r["corpus"] == "scannet")
        _profile_pretrain(torch, runner, corpora[0], scannet["load_ms"] + scannet["build_ms"]
                          + scannet["step_ms"], label="data")

        # 6. one render with the trained renderer; kernel C against its plain
        # version on the inputs it got (outside the counted windows)
        state = _render_state(torch, cfg.fields)
        seen, real = [], nerf.fused_nerf_mlp

        def recording(x, *w):
            seen.append((x, w))
            return real(x, *w)

        nerf.fused_nerf_mlp = recording
        try:
            with torch.no_grad():
                view = nerf.render_view(runner.params["render"], cfg.fields, state,
                                        torch.tensor([0.3, -0.2, 1.25], device="cuda"),
                                        torch.tensor(0.7, device="cuda"))
        finally:
            nerf.fused_nerf_mlp = real
        if not seen or not all(bool(torch.isfinite(t.float()).all()) for t in view):
            raise AssertionError("data render: kernel C did not run or the view is not finite")
        c_err, c_tol = 0.0, 0.0
        for x, w in seen:
            ok, dk = nerf_mlp_cuda(x, *w)
            op, dp = nerf_mlp_plain(x, *w)
            c_tol = max(c_tol, _bf16_tol(op), _bf16_tol(dp))
            c_err = max(c_err, (ok.float() - op.float()).abs().max().item(),
                        (dk.float() - dp.float()).abs().max().item())
        if not c_err <= c_tol:
            raise AssertionError(f"data render: kernel C err {c_err} > {c_tol}")
        log(f"[data] render N={seen[0][0].shape[0]} kernel C vs plain max_abs_err={c_err} "
            f"(tol {c_tol})")

        # 7. discrete_to_ce, read back
        d2c = os.path.join(tmp, "discrete")
        os.makedirs(d2c)
        items, conn = write_discrete_dataset(d2c, seed=9)
        t0 = time.perf_counter()
        discrete_to_ce.main(["--input", items, "--connectivity", conn, "--dataset",
                             "navrag_val", "--out", os.path.join(d2c, "val.json.gz"),
                             "--out-gt", os.path.join(d2c, "val_gt.json.gz")])
        secs["discrete_to_ce"] = time.perf_counter() - t0
        eps = datasets.load_episodes(os.path.join(d2c, "val.json.gz"))
        gts = datasets.load_gt(os.path.join(d2c, "val_gt.json.gz"))
        if not eps or sorted(gts) != sorted(e.episode_id for e in eps):
            raise AssertionError(f"discrete_to_ce: {len(eps)} episodes, {len(gts)} gt records")
        log(f"[data] discrete_to_ce: 300 items -> {len(eps)} episodes in "
            f"{secs['discrete_to_ce'] * 1e3:.1f} ms, read back")

        # 8. DAgger collection into the episode store, replayed
        store = os.path.join(tmp, "dagger.bin")
        t0 = time.perf_counter()
        n = dagger.collect_trajectories(cfg, lambda: FloorplanFeed(rgb_size=336, depth_size=256),
                                        store, episodes=2)
        secs["collect"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        replay = [(step[4], meta) for step, meta in dagger.iterate_store(store)]
        secs["replay"] = time.perf_counter() - t0
        if len(replay) != n or not all(gt.endswith("<|end|>") for gt, _ in replay):
            raise AssertionError(f"dagger: {n} steps stored, {len(replay)} replayed")
        log(f"[data] collect_trajectories 2 FloorplanFeed episodes: {n} steps, "
            f"{os.path.getsize(store) / 2**20:.1f} MiB in {secs['collect'] * 1e3:.1f} ms; "
            f"iterate_store {secs['replay'] * 1e3:.1f} ms")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[data] params_moved_l1={moved:.6g} seconds {json.dumps(secs)}")
    ctx["data_launches"] = {k: total[k] for k in ("nerf_mlp", "knn_topk")}


# --- dist and soak: the parallel layer and the training soak ---------------


def _digest(torch, tree):
    """One int64 a leaf over its raw bits (position-weighted, wrapping
    sums): equal lists for bit-identical trees, different ones for any
    other in practice."""
    from dynam3d_torch.utils.tree import tree_leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_leaves(tree):
        bits = t.detach().contiguous().view(ints[t.element_size()]).reshape(-1).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 1000003 + 1
        out.append(int((bits * w).sum()))
        del bits, w
    return out


def _same_on_every_rank(values) -> bool:
    """Whether every rank of the default group holds the same ``values``."""
    import numpy as np
    import torch.distributed as dist

    from dynam3d_torch.utils.misc import gather_list_and_concat

    rows = gather_list_and_concat(np.asarray(values, np.int64)[None], dist.group.WORLD)
    return bool((rows == rows[0]).all())


def _dist_small(torch, dev, rows, dp=None):
    """The small config's IL step (float32 Phi-3, lr 1e-3, seed 11): one
    process on the two rows, or one row a rank of ``dp``.  Returns the
    loss, the global norm and the trainable leaves before and after."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from dynam3d_torch.models import policy
    from dynam3d_torch.runtime import trainer_vln
    from dynam3d_torch.utils.tree import tree_leaves

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=1e-3))
    params = policy.init_policy_params(torch.Generator(device=dev).manual_seed(11), cfg,
                                       llm_dtype=torch.float32, device=dev)
    trainable, frozen = trainer_vln.split_params(params)
    before = [t.cpu().clone() for t in tree_leaves(trainable)]
    opt = trainer_vln.make_optimizer(cfg)
    state = opt.init(trainable)
    step = trainer_vln.make_train_step(cfg, opt, rows["splice"], dp=dp)
    B = 2 if dp is None else 1
    sel = slice(0, 2) if dp is None else slice(dist.get_rank(), dist.get_rank() + 1)
    batch = trainer_vln.TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)
                                     for a in rows["batch"]))
    _, _, _, m = step(trainable, frozen, state, policy.batched_init_state(cfg, B, dev), batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), before=before,
                after=[t.cpu().clone() for t in tree_leaves(trainable)])


def _dist_small_rows(torch):
    """Two rows of the small config: two 1-view rooms, one prompt."""
    import numpy as np

    from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer, build_prompt
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    cfg = _tiny_config()
    obs = [SyntheticRoomFeed(rgb_size=56, depth_size=32, views=1, seed=s).reset()
           for s in (2, 3)]
    tok = ByteTokenizer(cfg.llava.phi3.vocab_size)
    gt = "turn right 3 steps, move 2 steps.<|end|>"
    n_mm = 16 + 64 + 32
    ids = tok.encode(build_prompt(obs[0].instruction, ["none\n"] * 4, n_mm, gt))
    lab = tok.encode(gt, add_bos=False)
    T, Tg = -(-len(ids) // 64) * 64, -(-len(lab) // 16) * 16
    a = np.full((2, T), tok.pad_id, np.int64)
    v = np.zeros((2, T), bool)
    a[:, : len(ids)], v[:, : len(ids)] = ids, True
    la = np.full((2, Tg), tok.pad_id, np.int64)
    lm = np.zeros((2, Tg), bool)
    la[:, : len(lab)], lm[:, : len(lab)] = lab, True
    splice = tok.encode(build_prompt("x", ["none\n"] * 4, 1)).index(tok.image_id)
    batch = (np.stack([o.rgb for o in obs]), np.stack([o.depth for o in obs]),
             np.stack([np.float32(o.position) for o in obs]),
             np.float32([o.heading for o in obs]), a, v, la, lm, np.ones(2, np.float32))
    return {"batch": batch, "splice": splice}


def _il_full_step(torch, dev, dp, seed: int):
    """One full-width IL step (the default config: bf16 Phi-3-mini, the
    waypoint predictor over a 12-view room) through ``VLNTrainer`` on this
    rank's feed; returns its record and the trainable tree's digest."""
    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models import policy
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.parallel import comm
    from dynam3d_torch.runtime import trainer_vln
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed
    from dynam3d_torch.runtime.vln_loop import VLNTrainer

    t0 = time.perf_counter()
    cfg = Dynam3DConfig()
    params = policy.init_policy_params(torch.Generator(device=dev).manual_seed(5), cfg,
                                       device=dev)
    timed = []
    mean_ = trainer_vln.dp_mean_

    def timed_mean(*a, **k):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = mean_(*a, **k)
        torch.cuda.synchronize(dev)
        timed.append((time.perf_counter() - t) * 1e3)
        return out

    trainer_vln.dp_mean_ = timed_mean
    try:
        tr = VLNTrainer(params, cfg, lambda: SyntheticRoomFeed(rgb_size=336, depth_size=256,
                                                               views=12, seed=seed),
                        device=dev, dp=dp)
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        comm.reset_counts()
        kernels.reset_counts()
        t0 = time.perf_counter()
        tr.train_episode(max_steps=1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        trainer_vln.dp_mean_ = mean_
    st = tr.step_log[0]
    rec = dict(loss=st["loss"], grad_norm=st["grad_norm"], skipped=st["skipped"],
               step_ms=st["ms"], wall_s=wall, init_s=init_s, allreduce_ms=sum(timed),
               collectives=dict(comm.counts), launches=dict(kernels.launches),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return rec, _digest(torch, tr.trainable)


def _dist_rank(rank, world, dev, small_rows, workdir):
    """The ``dist`` phase on one of two gloo ranks sharing the card."""
    import gc

    import torch
    import torch.distributed as dist

    from dynam3d_torch.device import pin_full_fp32

    pin_full_fp32()
    group = dist.group.WORLD
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. the small config against one process, then one full-width IL step
    out["small"] = _dist_small(torch, dev, small_rows, dp=group)
    free()
    rec, dig = _il_full_step(torch, dev, group, seed=100 + rank)
    rec["identical"] = _same_on_every_rank(dig)
    out["il"] = rec
    del dig
    free()

    # 2. one full-width pretraining step, one scene a rank
    out["pretrain"] = _dist_pretrain(torch, dev, group)
    free()

    # 4. tensor-parallel greedy decode at Phi-3-mini width, float32
    out["tp"] = _dist_tp(torch, dev)
    free()

    # 5. rank-sharded int4 evaluate, merged, then one process's on rank 0
    out["eval"] = _dist_eval(torch, dev, rank, world, workdir)
    free()

    # 3. run.main at WORLD_SIZE = 2 (the group above), unequal episodes
    out["cli"] = _dist_cli(torch, dev, rank, workdir)
    dist.barrier()
    free()

    # 6. run.main's SS-ETP at WORLD_SIZE = 2: a walk, then a frames iteration
    out["ssetp"] = _dist_ssetp(torch, dev, rank, workdir)
    free()

    # 7. run.main's eval and inference at WORLD_SIZE = 2 on int4 weights, merged
    out["cli_eval"] = _dist_cli_eval(torch, dev, rank, workdir)
    return out


def _dist_pretrain(torch, dev, group):
    import torch.distributed as dist

    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models.encoders.clip import init_clip_params
    from dynam3d_torch.models.memory3d import init_field_params, init_state
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import trainer_3dff
    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner, SyntheticFramesDataset

    cfg = Dynam3DConfig()
    gen = torch.Generator(device=dev).manual_seed(7)
    params = {"fields": init_field_params(gen, cfg.fields, dev),
              "render": init_render_params(gen, cfg.fields, dev)}
    clip = init_clip_params(gen, cfg.clip, dev)
    runner = PretrainRunner({**params, "clip": clip}, cfg, device=dev)
    ds = SyntheticFramesDataset(rgb_size=336, depth_size=256, frames=8, seed=0)
    scenes = [ds.sample_scene() for _ in range(2)]
    batch = runner.build_batch(scenes[dist.get_rank()], clip)
    opt = trainer_3dff.make_pretrain_optimizer(cfg)
    step = trainer_3dff.make_pretrain_step(cfg, opt, posed=False, dp=group)
    opt_state = opt.init(params)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    new, _, _, m = step(params, opt_state, init_state(cfg.fields, dev), batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return dict(loss=float(m["loss"]), skipped=bool(m["skipped"]), wall_s=wall,
                renders=int(batch.novel_position.shape[0]),
                launches=dict(kernels.launches), plain=dict(kernels.plain_calls),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                identical=_same_on_every_rank(_digest(torch, new)))


def _tp_inputs(torch, dev):
    """Phi-3-mini at full width in float32 from seed 21 and a 64-token
    prompt of ids from seed 22."""
    import numpy as np

    from dynam3d_torch.config import Phi3Config
    from dynam3d_torch.models.vlm import phi3

    cfg = Phi3Config()
    params = phi3.init_phi3_params(torch.Generator(device=dev).manual_seed(21), cfg,
                                   dtype=torch.float32, device=dev)
    ids = torch.as_tensor(np.random.default_rng(22).integers(2, 32000, (1, 64)), device=dev)
    return cfg, params, ids


def _tp_reference(torch):
    """One process's 20 greedy ids and, for each, the top-2 margin of its
    logits and their scale (max |logit|), from one prefill over the prompt
    and the ids."""
    from dynam3d_torch.models.vlm import phi3

    cfg, params, ids = _tp_inputs(torch, "cuda")
    valid = torch.ones_like(ids, dtype=torch.bool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = phi3.greedy_decode(params, cfg, phi3.embed(params, ids), valid, 20)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    seq = torch.cat([ids, out[:, :19]], 1)
    T = seq.shape[1]
    cache = phi3.init_cache(cfg, 1, T, torch.float32, "cuda")
    logits, _ = phi3.forward(params, cfg, phi3.embed(params, seq), torch.arange(T, device="cuda")[None],
                             cache, 0, phi3.prefill_mask(torch.ones_like(seq, dtype=torch.bool), T))
    lg = logits[0, 63:]
    top2 = lg.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    scales = lg.abs().amax(-1).tolist()
    del params, cache, logits
    return dict(ids=out[0].tolist(), margins=margins, scales=scales, ms=ms)


def _dist_tp(torch, dev):
    from dynam3d_torch.models.vlm import phi3
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.parallel import comm
    from dynam3d_torch.parallel.mesh import (
        make_mesh, phi3_param_specs, shard_tree, split_qkv_params,
    )

    mesh = make_mesh(1, 2)
    cfg, params, ids = _tp_inputs(torch, dev)
    split = split_qkv_params(params, cfg)
    del params
    sh = shard_tree(split, phi3_param_specs(split), mesh)
    del split
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    comm.reset_counts()
    kernels.reset_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    emb = phi3.embed(sh, ids, mesh.tp_group)
    out = phi3.greedy_decode(sh, cfg, emb, torch.ones_like(ids, dtype=torch.bool), 20,
                             tp=mesh.tp_group)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(ids=out[0].tolist(), ms=ms, counts=dict(comm.counts),
                launches={k: v for k, v in kernels.launches.items() if v},
                fused=phi3._fused_decode_eligible(sh, cfg, 1),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, layers=cfg.num_layers)


def _eval_feeds():
    """Four rooms, goals varied by index (the eval soak's odd episodes)."""
    import numpy as np

    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    feeds = [SyntheticRoomFeed(rgb_size=336, depth_size=256, seed=i,
                               goal=(4.0 + (i % 5), 5.0 + (i % 3))) for i in range(4)]
    gts = []
    for f in feeds:
        start = np.asarray(f.reset().position, np.float32)
        gts.append(np.stack([start + t * (f.goal - start) for t in np.linspace(0, 1, 8)]))
    return feeds, gts


def _dist_eval(torch, dev, rank, world, workdir):
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models import policy
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import vln_loop
    from dynam3d_torch.utils.misc import gather_list_and_concat

    cfg = Dynam3DConfig()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_traj_len=3))
    params = policy.init_policy_params(torch.Generator(device=dev).manual_seed(9), cfg,
                                       device=dev)
    params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=4, consume=True)
    out_dir = os.path.join(workdir, "eval")
    feeds, gts = _eval_feeds()
    kernels.reset_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vln_loop.evaluate(params, cfg, feeds, gts, out_dir=out_dir, ckpt_name="dist", rank=rank,
                      world=world, ignore_stop=True, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.launches), dict(kernels.plain_calls)
    with open(os.path.join(out_dir, f"stats_ep_dist_r{rank}_w{world}.json")) as f:
        per_ep = json.load(f)
    keys = sorted(next(iter(per_ep.values())))
    mine = np.asarray([[len(per_ep)] + [sum(m[k] for m in per_ep.values()) for k in keys]],
                      np.float64)
    rows = gather_list_and_concat(mine, dist.group.WORLD)
    merged = dict(zip(keys, (rows[:, 1:].sum(0) / rows[:, 0].sum()).tolist()))
    one = None
    if rank == 0:
        feeds, gts = _eval_feeds()
        one = vln_loop.evaluate(params, cfg, feeds, gts, ckpt_name="one", ignore_stop=True,
                                device=dev)
    dist.barrier()
    return dict(episodes=sorted(per_ep, key=int), merged=merged, one=one, wall_s=wall,
                launches=launches, plain=plain,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def _dist_cli(torch, dev, rank, workdir):
    """``run.main`` at this world size: 1 iteration of at most 1 step on
    rank 0 and 2 on rank 1 (unequal episodes), rank 0 saving."""
    from dynam3d_torch import run
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import vln_loop

    seen = {}
    train = vln_loop.VLNTrainer.train

    def recording(self, *a, **k):
        out = train(self, *a, **k)
        seen.update(steps=len(self.step_log), idle=self.idle_steps,
                    digest=_digest(torch, self.trainable))
        return out

    cwd = os.getcwd()
    os.chdir(workdir)
    vln_loop.VLNTrainer.train = recording
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        run.main(["--run-type", "train", "--exp_name", "dist", "train.iters=1",
                  f"train.max_traj_len={1 + rank}", "train.log_every=1"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        vln_loop.VLNTrainer.train = train
        os.chdir(cwd)
    return dict(wall_s=wall, steps=seen["steps"], idle=seen["idle"],
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                launches={k: v for k, v in kernels.launches.items() if v},
                identical=_same_on_every_rank(seen["digest"]),
                digest=seen["digest"] if rank == 0 else None)


SSETP_SEED = 6   # draw_dataset_id(6, it, 3) = 0, 1: the walk, then the unposed frames


def _dist_ssetp(torch, dev, rank, workdir):
    """``run.main`` for SS-ETP at this world size: 2 iterations (a walk of
    at most 2 steps, then a frames iteration), recording the dataset drawn
    and the renders of each, the launches, and the trained tree's digest
    after each iteration."""
    from dynam3d_torch import run
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import pretrain_loop, trainer_3dff

    draws, renders, digests = [], [], []
    draw, rv, rvp = (trainer_3dff.draw_dataset_id, trainer_3dff.render_view,
                     trainer_3dff.render_view_posed)
    run_iters = pretrain_loop.PretrainRunner.run

    def drawing(*a):
        draws.append(draw(*a))
        renders.append(0)
        return draws[-1]

    def counted(fn):
        def render(*a, **k):
            renders[-1] += 1
            return fn(*a, **k)
        return render

    def stepwise(self, datasets, iters, logger=None, ckpt_dir=None, log_every=100):
        hist = []
        for _ in range(iters):
            hist += run_iters(self, datasets, 1, logger, ckpt_dir, log_every)
            digests.append(_digest(torch, {"fields": self.params["fields"],
                                           "render": self.params["render"]}))
        return hist

    cwd = os.getcwd()
    os.chdir(workdir)
    trainer_3dff.draw_dataset_id = drawing
    trainer_3dff.render_view, trainer_3dff.render_view_posed = counted(rv), counted(rvp)
    pretrain_loop.PretrainRunner.run = stepwise
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        run.main(["--run-type", "train", "--trainer", "SS-ETP", "--exp_name", "pre",
                  "--ckpt-dir", os.path.join(workdir, "pre_ckpt"), "train.iters=2",
                  f"train.seed={SSETP_SEED}", "train.pretrain_traj_len=2",
                  "train.log_every=2"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        trainer_3dff.draw_dataset_id = draw
        trainer_3dff.render_view, trainer_3dff.render_view_posed = rv, rvp
        pretrain_loop.PretrainRunner.run = run_iters
        os.chdir(cwd)
    return dict(wall_s=wall, draws=draws, renders=renders,
                identical=[_same_on_every_rank(d) for d in digests],
                launches={k: v for k, v in kernels.launches.items() if v},
                plain={k: v for k, v in kernels.plain_calls.items() if v},
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def _int4_policy(init):
    """``init_policy_params`` with Phi-3 packed to int4 (the CLI runs dense
    bf16 Phi-3, as the reference's does; the int4 decode kernels serve
    evaluation in the eval soak)."""
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3

    def init_int4(*a, **k):
        params = init(*a, **k)
        params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=4, consume=True)
        return params
    return init_int4


def _dist_cli_eval(torch, dev, rank, workdir):
    """``run.main`` for eval and inference at this world size on int4
    weights (8 and 4 episodes of at most 2 steps, sharded by rank, merged
    by rank 0), then on rank 0 the same two runs as one process
    (``WORLD_SIZE=1``) over the same feeds; returns the launches of this
    rank's window and, on rank 0, both sets of files."""
    import torch.distributed as dist

    from dynam3d_torch import run
    from dynam3d_torch.models import policy
    from dynam3d_torch.ops import kernels

    init = policy.init_policy_params
    cwd = os.getcwd()
    os.chdir(workdir)
    policy.init_policy_params = _int4_policy(init)
    argv = ["train.max_traj_len=2"]
    try:
        torch.cuda.synchronize(dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        for kind in ("eval", "inference"):
            run.main(["--run-type", kind, "--exp_name", "merged"] + argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
        plain = {k: v for k, v in kernels.plain_calls.items() if v}
        dist.barrier()
        files = None
        if rank == 0:
            env = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE")}
            os.environ.update(RANK="0", WORLD_SIZE="1")
            try:
                for kind in ("eval", "inference"):
                    run.main(["--run-type", kind, "--exp_name", "one"] + argv)
            finally:
                os.environ.update(env)
            files = {}
            for name in ("merged", "one"):
                with open(os.path.join("data", "eval", name, "stats_ckpt.json")) as f:
                    stats = json.load(f)
                with open(os.path.join("data", "eval", f"{name}_preds.json")) as f:
                    files[name] = (stats, json.load(f))
            files["rank_files"] = sorted(os.listdir(os.path.join("data", "eval", "merged")))
        dist.barrier()
    finally:
        policy.init_policy_params = init
        os.chdir(cwd)
    return dict(wall_s=wall, launches=launches, plain=plain, files=files)


def _nccl_rank(rank, world, dev):
    """The full-width IL step on a one-rank NCCL group (the NCCL path of
    the gradient average)."""
    import torch
    import torch.distributed as dist

    from dynam3d_torch.device import pin_full_fp32

    pin_full_fp32()
    rec, _ = _il_full_step(torch, dev, dist.group.WORLD, seed=100)
    rec["backend"] = dist.get_backend()
    return rec


def _update_agreement(before, ref, got):
    """The CPU test's measure: the share of elements whose updates have
    opposite signs (worst leaf) and the largest other difference over the
    update's size."""
    worst_flip, worst_err = 0.0, 0.0
    for p0, a, b in zip(before, ref, got):
        ua, ub = (a - p0).double(), (b - p0).double()
        size = float(ua.abs().max())
        flipped = (ua.sign() * ub.sign()) < 0
        worst_flip = max(worst_flip, float(flipped.float().mean()))
        if size > 0 and bool((~flipped).any()):
            worst_err = max(worst_err, float((ub - ua)[~flipped].abs().max()) / size)
    return worst_flip, worst_err


def phase_dist(ctx):
    """The parallel layer on two gloo ranks sharing the card (NCCL refuses
    two ranks on one device), then a one-rank NCCL group."""
    torch = ctx["torch"]
    import gc
    import tempfile

    from dynam3d_torch.ops import kernels
    from dynam3d_torch.parallel.spawn import run_ranks
    from dynam3d_torch.runtime import checkpoint as ckpt_mod

    t_phase = time.perf_counter()
    kernels.build_all()             # before the ranks, which then only load it
    ctx.pop("serve", None)
    gc.collect()
    torch.cuda.empty_cache()
    rows = _dist_small_rows(torch)
    small_ref = _dist_small(torch, "cuda", rows)
    tp_ref = _tp_reference(torch)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[dist] one process: small step loss={small_ref['loss']:.6f} "
        f"grad_norm={small_ref['grad_norm']:.6f}; Phi-3-mini f32 greedy 20 ids in "
        f"{tp_ref['ms']:.1f} ms, least top-2 margin {min(tp_ref['margins']):.3e}")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        ranks = run_ranks(_dist_rank, 2, args=(rows, work), device="cuda",
                          backend="gloo", timeout=900)
        gloo_s = time.perf_counter() - t0
        ck = os.path.join(work, "data", "checkpoints", "ckpt.iter1")
        names = os.listdir(os.path.dirname(ck))
        payload = ckpt_mod.load_to_device(ck, "cuda")
        ck_digest = _digest(torch, payload["trainable"])
        ck_count = payload["opt_state"]["count"]
        del payload
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nccl = run_ranks(_nccl_rank, 1, device="cuda", backend="nccl", timeout=600)[0]
    nccl_s = time.perf_counter() - t0
    fails = []

    # 1. IL
    for r, out in enumerate(ranks):
        il, sm = out["il"], out["small"]
        share = il["allreduce_ms"] / il["step_ms"] if il["step_ms"] else float("nan")
        log(f"[dist] rank {r} IL step (gloo, dp=2): loss={il['loss']:.6f} "
            f"grad_norm={il['grad_norm']:.4f} step_ms={il['step_ms']:.1f} "
            f"allreduce_ms={il['allreduce_ms']:.1f} share={share:.3f} wall_s={il['wall_s']:.2f} "
            f"init_s={il['init_s']:.2f} peak_gib={il['peak_gib']:.2f} collectives "
            f"{json.dumps(il['collectives'])} launches "
            f"{json.dumps({k: v for k, v in il['launches'].items() if v})} "
            f"identical={il['identical']}")
        if il["skipped"] or not math.isfinite(il["loss"]) or not il["identical"]:
            fails.append(f"IL step rank {r}: {il}")
        flip, err = _update_agreement(small_ref["before"], small_ref["after"], sm["after"])
        rel = abs(sm["loss"] - small_ref["loss"]) / abs(small_ref["loss"])
        rel_n = abs(sm["grad_norm"] - small_ref["grad_norm"]) / abs(small_ref["grad_norm"])
        log(f"[dist] rank {r} small dp=2 vs one process: loss rel {rel:.2e}, grad_norm rel "
            f"{rel_n:.2e}, flipped share {flip:.2e}, update err / size {err:.2e} "
            f"(tolerances 1e-4, 1e-4, 1e-3, 1e-4)")
        if not (rel <= 1e-4 and rel_n <= 1e-4 and flip <= 1e-3 and err <= 1e-4):
            fails.append(f"small dp step rank {r} disagrees with one process")
    log(f"[dist] NCCL one rank IL step: loss={nccl['loss']:.6f} step_ms={nccl['step_ms']:.1f} "
        f"allreduce_ms={nccl['allreduce_ms']:.1f} wall_s={nccl['wall_s']:.2f} peak_gib="
        f"{nccl['peak_gib']:.2f} launches "
        f"{json.dumps({k: v for k, v in nccl['launches'].items() if v})} "
        f"backend={nccl['backend']} in {nccl_s:.1f} s")
    if nccl["skipped"] or not math.isfinite(nccl["loss"]) or nccl["backend"] != "nccl":
        fails.append(f"NCCL IL step: {nccl}")

    # 2. pretraining
    pre_launch = {}
    for r, out in enumerate(ranks):
        p = out["pretrain"]
        log(f"[dist] rank {r} pretrain step (dp=2): mean loss={p['loss']:.6f} "
            f"wall_s={p['wall_s']:.2f} peak_gib={p['peak_gib']:.2f} renders={p['renders']} "
            f"launches {json.dumps({k: v for k, v in p['launches'].items() if v})} "
            f"identical={p['identical']}")
        pre_launch = {k: pre_launch.get(k, 0) + v for k, v in p["launches"].items()}
        if (not math.isfinite(p["loss"]) or p["skipped"] or not p["identical"]
                or p["launches"]["nerf_mlp"] != p["renders"] or any(p["plain"].values())):
            fails.append(f"pretrain rank {r}: loss {p['loss']}, identical {p['identical']}, "
                         f"C {p['launches']['nerf_mlp']} of {p['renders']} renders, plain "
                         f"{({k: v for k, v in p['plain'].items() if v})}")

    # 3. run.main
    for r, out in enumerate(ranks):
        c = out["cli"]
        log(f"[dist] rank {r} run.main WORLD_SIZE=2: {c['steps']} steps, {c['idle']} idle, "
            f"wall_s={c['wall_s']:.1f} peak_gib={c['peak_gib']:.2f} launches "
            f"{json.dumps(c['launches'])} identical={c['identical']}")
        if not c["identical"] or c["steps"] + c["idle"] != 2:
            fails.append(f"run.main rank {r}: {c}")
    same_ck = ck_digest == ranks[0]["cli"]["digest"]
    log(f"[dist] rank 0 checkpoint {names}: trainable equal to the ranks' {same_ck}, "
        f"optimizer count {ck_count}")
    if names != ["ckpt.iter1"] or not same_ck:
        fails.append("run.main: rank 0's checkpoint differs from the trained tree")

    # 4. TP decode
    L = ranks[0]["tp"]["layers"]
    for r, out in enumerate(ranks):
        t = out["tp"]
        c = t["counts"]
        passes = c.get("logits", 0)
        diff = next((i for i, (a, b) in enumerate(zip(t["ids"], tp_ref["ids"])) if a != b),
                    None)
        log(f"[dist] rank {r} TP=2 greedy 20 ids in {t['ms']:.1f} ms, peak_gib="
            f"{t['peak_gib']:.2f}, collectives {json.dumps(c)} ({passes} passes), launches "
            f"{json.dumps(t['launches'])}, first difference {diff}")
        if diff is not None:
            m, s = tp_ref["margins"][diff], tp_ref["scales"][diff]
            log(f"[dist] one-process top-2 margin at {diff}: {m:.3e} of scale {s:.3e}")
            if m >= 1e-4 * s:
                fails.append(f"TP ids differ at {diff} with a margin {m} >= 1e-4 x {s}")
        if c.get("layer") != 2 * L * passes or t["fused"]:
            fails.append(f"TP collectives {c}, fused {t['fused']}")

    # 5. eval
    merged = ranks[0]["eval"]["merged"]
    one = ranks[0]["eval"]["one"]
    eval_launch = {}
    for r, out in enumerate(ranks):
        e = out["eval"]
        log(f"[dist] rank {r} eval episodes {e['episodes']} wall_s={e['wall_s']:.2f} "
            f"peak_gib={e['peak_gib']:.2f} launches "
            f"{json.dumps({k: v for k, v in e['launches'].items() if v})}")
        eval_launch = {k: eval_launch.get(k, 0) + v for k, v in e["launches"].items()}
        if (e["launches"]["int4_matvec"] <= 0 or e["launches"]["decode_attn"] <= 0
                or any(e["plain"].values()) or e["merged"] != merged):
            fails.append(f"eval rank {r}: A {e['launches']['int4_matvec']}, B "
                         f"{e['launches']['decode_attn']}, plain "
                         f"{({k: v for k, v in e['plain'].items() if v})}, merged {e['merged']}")
    err = max(abs(merged[k] - one[k]) for k in one)
    log(f"[dist] eval merged {json.dumps(merged)} vs one process, max diff {err:.2e}")
    if sorted(merged) != sorted(one) or err > 1e-6:
        fails.append("eval: merged metrics differ from one process's")

    # 6. SS-ETP through run.main
    for r, out in enumerate(ranks):
        p = out["ssetp"]
        log(f"[dist] rank {r} run.main SS-ETP WORLD_SIZE=2: datasets {p['draws']} renders "
            f"{p['renders']} wall_s={p['wall_s']:.1f} peak_gib={p['peak_gib']:.2f} launches "
            f"{json.dumps(p['launches'])} identical after each iteration {p['identical']}")
        pre_launch = {k: pre_launch.get(k, 0) + v for k, v in p["launches"].items()}
        if (p["draws"] != [0, 1] or p["draws"] != ranks[0]["ssetp"]["draws"]
                or not all(p["identical"]) or len(p["identical"]) != 2
                or not 0 < sum(p["renders"]) <= p["launches"].get("nerf_mlp", 0)
                or p["plain"]):
            fails.append(f"run.main SS-ETP rank {r}: {p}")

    # 7. eval and inference through run.main, merged by rank 0
    for r, out in enumerate(ranks):
        c = out["cli_eval"]
        log(f"[dist] rank {r} run.main eval + inference WORLD_SIZE=2 (int4): "
            f"wall_s={c['wall_s']:.1f} launches {json.dumps(c['launches'])}")
        eval_launch = {k: eval_launch.get(k, 0) + v for k, v in c["launches"].items()}
        if not c["launches"].get("int4_matvec") or not c["launches"].get("decode_attn") \
                or c["plain"]:
            fails.append(f"run.main eval rank {r}: launches {c['launches']}, plain {c['plain']}")
    files = ranks[0]["cli_eval"]["files"]
    (m_stats, m_preds), (o_stats, o_preds) = files["merged"], files["one"]
    err = max(abs(m_stats[k] - o_stats[k]) for k in o_stats)
    log(f"[dist] run.main merged stats {json.dumps(m_stats)}, max diff from one process "
        f"{err:.2e}; preds {sorted(m_preds)} equal {m_preds == o_preds}; rank files "
        f"{files['rank_files']}")
    if (sorted(m_stats) != sorted(o_stats) or err > 1e-6 or m_preds != o_preds
            or list(m_preds) != list(o_preds)
            or files["rank_files"] != ["stats_ckpt.json", "stats_ep_ckpt_r0_w2.json",
                                       "stats_ep_ckpt_r1_w2.json"]):
        fails.append("run.main eval / inference: merged files differ from one process's")
    log(f"[dist] gloo ranks {gloo_s:.1f} s, NCCL rank {nccl_s:.1f} s, the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    ctx["dist_launches"] = {k: eval_launch.get(k, 0) + pre_launch.get(k, 0)
                            for k in ("int4_matvec", "decode_attn", "nerf_mlp")}
    if fails:
        raise AssertionError("dist: " + "; ".join(str(f) for f in fails))


# over the logits' scale: a top-2 margin under TIE_TOL is a near-tie, where
# two routes may pick different ids; the fused and unfused routes round the
# bf16 residual stream at other points in each of 32 layers, and their
# one-step logits may differ by LOGITS_TOL
TIE_TOL = 0.05
LOGITS_TOL = 0.10


def _tool_window(torch, name, fn, want=(), fails=None):
    """``fn()`` with the launch counters reset just before and read just
    after: each kernel of ``want`` must launch, no plain version may run."""
    from dynam3d_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches.items() if v}
    plain = {k: v for k, v in kernels.plain_calls.items() if v}
    log(f"[tools] {name}: {wall:.1f} s, launches {json.dumps(launches)}")
    missing = [k for k in want if not launches.get(k)]
    if missing or plain:
        fails.append(f"{name}: kernels {missing} not launched, plain versions {plain}")
    return out, launches


def phase_tools(ctx):
    """The profiling and A/B tools at full width on one policy (the default
    config, int4 Phi-3-mini), each in a counted window: decode parts, the
    fused routes, speculation at B = 1 and batched, the prefill split and
    its products, the perceive stages and the B = 1 step's host / device
    split."""
    torch = ctx["torch"]
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.tools import (
        ab_fused_decode, ab_spec_batched, ab_spec_decode, bench_int8_prefill, prof_decode_parts,
        prof_full_step, prof_prefill, profile_perceive,
    )

    kernels.build_all()
    cfg, params = _serving_params(ctx)
    pcfg, phi3 = cfg.llava.phi3, params["llava"]["phi3"]
    dev = torch.device("cuda")
    fails, total = [], {}

    def window(name, fn, want=()):
        out, launches = _tool_window(torch, name, fn, want, fails)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return out

    A, B, F, G, H = ("int4_matvec", "decode_attn", "int4_mlp", "int4_mlp_block",
                     "decode_attn_layer")
    parts = window("prof_decode_parts", lambda: prof_decode_parts.run(
        phi3, pcfg, dev, iters=10), (A, B, F, G, H))
    par = parts["parity"]
    tol, tie = LOGITS_TOL * par["scale"], TIE_TOL * par["scale"]
    log(f"[tools] decode parts fused vs unfused logits: max abs {par['max_abs']:.4f} "
        f"(tolerance {tol:.4f}), argmax same {par['argmax_same']}, unfused top-2 margin "
        f"{par['top1_gap_unfused']:.4f} (a near-tie under {tie:.4f})")
    if par["max_abs"] > tol or (not par["argmax_same"] and par["top1_gap_unfused"] >= tie):
        fails.append(f"prof_decode_parts parity {par['max_abs']} > {tol} or argmax differs")
    for b, want in ((1, (A, B, F, G, H)), (4, (A, B, F))):
        ab = window(f"ab_fused_decode B={b}", lambda b=b: ab_fused_decode.run(
            phi3, pcfg, dev, batch=b, tokens=(12, 4), reps=2, tol=TIE_TOL,
            logits_tol=LOGITS_TOL), want)
        fails += [f"ab_fused_decode B={b} {name}: {r}" for name, r in ab["parity"].items()
                  if not r["ok"]]
    spec = window("ab_spec_decode", lambda: ab_spec_decode.run(
        phi3, pcfg, dev, tokens=(24, 8), reps=2, tol=TIE_TOL), (A, B))
    fails += [f"ab_spec_decode n={n}: {r['checks']}" for n, r in spec["runs"].items()
              if not r["ok"]]
    bat = window("ab_spec_batched", lambda: ab_spec_batched.run(
        phi3, pcfg, dev, tokens=(16, 4), reps=2, tol=TIE_TOL), (A, B))
    fails += [f"ab_spec_batched B={b} n={n}: {r['nolookup_vs_plain']}"
              for b, rb in bat.items() for n, r in rb["runs"].items() if not r["ok"]]
    pre = window("prof_prefill", lambda: prof_prefill.run(phi3, pcfg, dev, iters=3), (A,))
    window("bench_int8_prefill", lambda: bench_int8_prefill.run(dev, iters=10))
    stages = window("profile_perceive", lambda: profile_perceive.run(params, cfg, dev, reps=3))
    log("[tools] perceive stages p50 ms: " + ", ".join(
        f"{k} {v['p50_ms']:.1f}" for k, v in stages.items()))
    if "attribution" in pre:
        log(f"[tools] prefill: forward {pre['forward_w8a8']['ms']:.2f} ms, attributed "
            f"{pre['attribution']['attributed_ms']:.2f}, unattributed "
            f"{pre['attribution']['unattributed_ms']:.2f}")
    step = window("prof_full_step", lambda: prof_full_step.run(
        params, cfg, dev, n1=2, n2=5, reps=2), (A, B))
    log(f"[tools] B=1 step: {step['step_ms']:.1f} ms a step, device busy "
        f"{step['device_busy_step_ms'] or float('nan'):.1f} ms, host "
        f"{step['host_step_ms'] or float('nan'):.1f} ms, idle share "
        f"{step['idle_share'] if step['idle_share'] is not None else 'not measured'}")
    if not (step["step_ms"] and step["step_ms"] > 0):
        fails.append(f"prof_full_step: {step}")
    ctx["tools_launches"] = total
    if fails:
        raise AssertionError("tools: " + "; ".join(fails))


def phase_soak(ctx):
    """``dynam3d_torch.tools.train_soak --scale full --il-steps 8
    --pretrain-iters 4`` in a temporary work directory, its rows checked."""
    torch = ctx["torch"]
    import gc
    import signal
    import tempfile

    from dynam3d_torch.ops import kernels

    kernels.build_all()
    ctx.pop("serve", None)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "soak.jsonl")
        cmd = [sys.executable, "-m", "dynam3d_torch.tools.train_soak", "--out", out,
               "--scale", "full", "--il-steps", "8", "--pretrain-iters", "4",
               "--workdir", os.path.join(work, "wd")]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        wall = time.perf_counter() - t0
        rows = [json.loads(r) for r in open(out)] if os.path.exists(out) else []
    by = {}
    for r in rows:
        by.setdefault(r["phase"], []).append(r)
    for r in rows:
        log(f"[soak] {json.dumps(r)}")
    fails = []
    if proc.returncode != 0:
        fails.append(f"exit {proc.returncode}: {text[-4000:]}")
    want = {"meta": 2, "il": 8, "il_resume_check": 1, "il_summary": 1, "pretrain": 4,
            "pretrain_resume_check": 1, "pretrain_summary": 1}
    if {k: len(v) for k, v in by.items()} != want:
        fails.append(f"rows {({k: len(v) for k, v in by.items()})} != {want}")
    losses = [r["loss"] for r in by.get("il", []) + by.get("pretrain", [])]
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"losses {losses}")
    for name in ("il_resume_check", "pretrain_resume_check"):
        if not by.get(name) or by[name][0].get("bit_compatible") is not True:
            fails.append(f"{name}: {by.get(name)}")
    c_launches = [r.get("launches", {}).get("nerf_mlp", 0) for r in by.get("pretrain", [])]
    if not c_launches or min(c_launches) <= 0 or any(r.get("plain_calls")
                                                    for r in by.get("pretrain", [])):
        fails.append(f"kernel C per pretraining iteration {c_launches}")
    ctx["soak_launches"] = {"nerf_mlp": sum(c_launches)}
    log(f"[soak] wall_s={wall:.1f}")
    if fails:
        raise AssertionError("soak: " + "; ".join(fails))



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
    t_run = time.perf_counter()
    for name in phases:
        t0 = time.perf_counter()
        globals()[f"phase_{name}"](ctx)
        log(f"[{name}] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"[chip_smoke] phases {','.join(phases)} done in {time.perf_counter() - t_run:.1f} s")

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
    conv = ctx.get("convert_launches", {})
    data = ctx.get("data_launches", {})
    dist_l = ctx.get("dist_launches", {})
    soak_l = ctx.get("soak_launches", {})
    tools_l = ctx.get("tools_launches", {})
    for rec in kernels_rec:
        if rec["name"] in tools_l:
            rec["launches_tools"] = tools_l[rec["name"]]
        if rec["name"] in dist_l:
            rec["launches_dist"] = dist_l[rec["name"]]
        if rec["name"] in soak_l:
            rec["launches_soak"] = soak_l[rec["name"]]
        if rec["name"] in cli:
            rec["launches_cli"] = cli[rec["name"]]
        if rec["name"] in conv:
            rec["launches_convert"] = conv[rec["name"]]
        if rec["name"] in data:
            rec["launches_data"] = data[rec["name"]]
    print(json.dumps({"kernels": kernels_rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
