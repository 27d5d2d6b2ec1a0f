"""3DFF pretraining on posed-frames scenes: ``PretrainRunner.run`` over a
``SyntheticFramesDataset``, one iteration at a time, for the window (the
``3dff-pretrain-frames`` cell).

Set-up makes the weights from the seed on the card (``weights_fields.py``:
the frozen CLIP tower, the memory's modules, the renderer), builds the
runner and its ``SyntheticFramesDataset`` of 16-frame scenes (a seed of
its own drawn from ``--seed``: each seed its own stream of scenes), and
runs the traffic's warm iterations (the first builds kernel C).  The window then runs whole
iterations until ``--seconds`` have passed; ``step_ms`` is the window over
the iterations it completed.  With ``--trace 1`` the first iterations of
the window (``window.trace_iters``) are profiled; the benchmark's own spans
``load`` (the dataset's ``sample_scene``) and ``iter`` (one ``run``) name
the idle gaps, and the program's ``pretrain.*`` spans and counters are
kept for the readers (``perfbench/pretrain_spans.py``).

At iterations drawn from the seed the entry keeps, on the card, what the
check needs (``check_3dff.py``): the scene as the dataset gave it, the
trainable tree and the optimizer state before and after the step, and
the step's batch, folded table, per-view byproducts, renders and metrics.
The program functions it wraps for that (module attributes, which the
step looks up at each call) are ``trainer_3dff.losses_after_update``,
``.render_view`` and ``.focal_loss``, and ``nerf.knn_brute``; a wrapper
keeps references, and copies nothing.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import check_3dff, faults_3dff, flops, flops_fields, traffic, weights_fields
from perfbench.harness import since_start
from perfbench.reference import fields_ref
from perfbench.trace import Traced, span, span_seconds


class WindowDataset:
    """The frames dataset, each ``sample_scene`` in the benchmark's span
    ``load``, the last scene kept (a copy at the sampled iterations)."""

    def __init__(self, ds, fault=None):
        self.ds, self.fault = ds, fault
        self.keep = False
        self.last = None

    def sample_scene(self):
        with span("load"):
            scene = self.ds.sample_scene()
        self.last = copy.deepcopy(scene) if self.keep else None
        return faults_3dff.scene(self.fault, scene)


class Capture:
    """The wrappers of ``losses_after_update``, ``render_view``, the
    renderer's neighbour search (``nerf.knn_brute``) and the category
    focal loss (``focal_loss``) that keep an iteration's intermediate
    values while ``on``."""

    def __init__(self, mod, nerf):
        self.mod, self.nerf = mod, nerf
        self.losses0, self.render0 = mod.losses_after_update, mod.render_view
        self.knn0, self.focal0 = nerf.knn_brute, mod.focal_loss
        self.on = False
        self.got: Dict = {}

    def install(self):
        self.mod.losses_after_update, self.mod.render_view = self.losses, self.render
        self.nerf.knn_brute, self.mod.focal_loss = self.knn, self.focal

    def remove(self):
        self.mod.losses_after_update, self.mod.render_view = self.losses0, self.render0
        self.nerf.knn_brute, self.mod.focal_loss = self.knn0, self.focal0

    def losses(self, params, cfg, state, aux, batch, posed=False):
        if self.on:
            self.got.update(state=state, aux=aux, batch=batch, renders=[], neighbours=[])
        return self.losses0(params, cfg, state, aux, batch, posed=posed)

    def knn(self, queries, points, valid, k):
        out = self.knn0(queries, points, valid, k)
        if self.on:
            self.got["neighbours"].append((queries.detach(), out[1]))
        return out

    def focal(self, logits, targets, mask, *a, **k):
        if self.on:
            self.got["focal"] = (logits.detach(), targets, mask)
        return self.focal0(logits, targets, mask, *a, **k)

    def render(self, *a, **k):
        out = self.render0(*a, **k)
        if self.on:
            self.got["renders"].append(out)
        return out


def _sample_iters(seed: int, upto: int, n: int) -> set:
    """``n`` window iterations of the first ``upto``, drawn from the seed."""
    r = traffic.rng(seed, 23)
    return set(int(i) for i in r.choice(upto, size=min(n, upto), replace=False))


def run(ctx) -> Dict:
    from dynam3d_torch.config import from_dict
    from dynam3d_torch.models.render import nerf
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import pretrain_loop, trainer_3dff
    from dynam3d_torch.utils.tree import tree_leaves

    dev = ctx.device
    model = ctx.config["model"]
    cfg = from_dict(model)
    rcfg = fields_ref.config(model)
    tr = ctx.cell["traffic"]
    chk = ctx.cell["check"]
    sup_seed = int(traffic.rng(ctx.seed, 22).integers(1 << 31))

    # --- set-up: weights from the seed, the runner, warm iterations
    params = weights_fields.fields_params(ctx.seed, rcfg, dev)
    runner = pretrain_loop.PretrainRunner(params, cfg, seed=sup_seed, device=dev)
    faults_3dff.install(ctx.fault, runner)
    scenes = pretrain_loop.SyntheticFramesDataset(
        rgb_size=cfg.clip.image_size, depth_size=int(tr["depth_size"]), frames=int(tr["frames"]),
        seed=int(traffic.rng(ctx.seed, 21).integers(1 << 31)), use_labels=True)
    ds = WindowDataset(scenes, ctx.fault)
    for _ in range(int(tr["warm_iters"])):
        runner.run([ds], 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # --- the window
    sample_at = _sample_iters(ctx.seed, int(chk["sample_range"]), int(chk["sample_iters"]))
    n_trace = int(ctx.cell["window"]["trace_iters"]) if ctx.trace and dev.type == "cuda" else 0
    cap = Capture(trainer_3dff, nerf)
    samples: List[Dict] = []
    ms: List[float] = []
    traced, trace_open, trace_iters, trace_scenes = None, False, [], []
    launches0, launches1 = {}, {}
    fails = 0
    setup_s = since_start()
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    cap.install()
    try:
        k = 0
        while time.perf_counter() < deadline:
            if k == 0 and n_trace:
                launches0 = dict(kernels.launches)
                traced, trace_open = Traced().__enter__(), True
            take = k in sample_at
            ds.keep = take or k < n_trace
            cap.on = take
            cap.got = {}
            before = {"fields": runner.params["fields"], "render": runner.params["render"]}
            opt0 = getattr(runner, "_tr_opt", None)
            it = runner.it
            t0 = time.perf_counter()
            with span("iter"):
                m = runner.run([ds], 1)[0]
            ms.append(1e3 * (time.perf_counter() - t0))
            fails += int(bool(m["skipped"]) or not np.isfinite(m["loss"]))
            if k < n_trace:
                trace_iters.append(it)
                trace_scenes.append(ds.last)
                if k == n_trace - 1:
                    traced.__exit__(None, None, None)
                    trace_open = False
                    launches1 = dict(kernels.launches)
            if take:
                after = {"fields": runner.params["fields"], "render": runner.params["render"]}
                samples.append(dict(cap.got, it=it, sup_seed=sup_seed, scene=ds.last,
                                    metrics=m, tree_before=before,
                                    params_before=tree_leaves(before),
                                    params_after=tree_leaves(after), opt_before=opt0,
                                    opt_after=runner._tr_opt))
            k += 1
    finally:
        cap.remove()
        if trace_open:
            traced.__exit__(None, None, None)
            launches1 = dict(kernels.launches)
    t_end = time.perf_counter()
    window_s = t_end - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    hist = runner.timings[-len(ms):] if ms else []

    notes = {"iters": len(ms), "iter_ms_q": [float(np.percentile(ms, q))
                                             for q in (0, 10, 50, 90, 100)] if ms else [],
             "span_s": span_seconds(t_start, t_end),
             "timings_s": {k: float(np.mean([h[k] for h in hist])) for k in hist[0]} if hist
             else {}, "card_after": flops.card_state() if dev.type == "cuda" else "cpu"}
    e2e = {"setup_s": setup_s, "step_ms": 1e3 * window_s / max(len(ms), 1)}

    # what the per-layer readers read
    from dynam3d_torch.runtime import profiling

    layer = {"trace": traced.summarize() if traced is not None else None,
             "trace_iters": trace_iters, "fields": cfg.fields,
             "trace_launches": {n: v - launches0.get(n, 0) for n, v in launches1.items()},
             "program_spans": profiling.spans() if hasattr(profiling, "spans") else None,
             "program_counts": profiling.counts() if hasattr(profiling, "counts") else None}

    # --- the check, after the window, on the program's state freed
    names = [n for n, _ in fields_ref.leaves({"fields": runner.params["fields"],
                                              "render": runner.params["render"]})]
    del runner, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.trace and trace_scenes:
        layer["flops_per_iter"] = [flops_fields.step_flops(ctx.seed, rcfg, s, dev)
                                   for s in trace_scenes]
        gc.collect()
    got = check_3dff.readings(ctx, rcfg, samples, names)
    checks = check_3dff.judge(chk["limits"], got)
    notes["per_iteration"] = got.pop("_per_iteration")
    extra = {}
    if ctx.control:
        ctl = check_3dff.readings(ctx, rcfg, samples, names, control=True)
        ctl.pop("_per_iteration")
        extra["control"] = ctl
    del samples
    return {**extra, "notes": notes, "readings": got, "e2e": e2e, "layer": layer,
            "checks": checks, "attempted": len(ms), "failed": fails,
            "memory_peak_bytes": memory_peak, "trace": layer["trace"]}
