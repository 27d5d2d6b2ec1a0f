"""Training soak: multi-step training at full width with a mid-run
checkpoint and a bit-compatible resume, per-step loss / NaN / new-shape
accounting and a JSONL record.

    python -m dynam3d_torch.tools.train_soak --out runs/train_soak.jsonl \\
        [--il-steps 60] [--pretrain-iters 20] [--scale full|tiny] [--device cpu]

Port of ``tools/train_soak.py``, with its flags and row keys.  Two phases,
the reference's two training stages, each in a process of its own (the
first writes the ``meta`` row of each):

* IL: teacher-forced VLN imitation over the ``FloorplanFeed`` oracle
  (ss_trainer_Dynam3D.py:265-302, 786-798), ``--il-steps`` updates at the
  soak config (``eval_soak.soak_config``: the default with member caps 512
  / 128, bf16 Phi-3-mini at ``--scale full``); a checkpoint at the
  midpoint, and the loss of a fixed probe batch written beside it.  A
  fresh process (``--il-resume-check``) builds the policy from the same
  seed, loads the checkpoint into its trainable tensors and computes the
  probe's loss at the trainer's ``splice_start`` (saved beside it):
  ``bit_compatible`` when it equals the saved one exactly.  When that
  process fails, the row says ``"bit_compatible": false`` with the error,
  and the soak returns the child's exit code (the reference tool logs the
  error and returns 0).
* pretrain: 3DFF iterations over posed synthetic frames
  (ss_trainer_3DFF.py:504-519), a checkpoint of ``fields`` / ``render`` at
  the midpoint, then a fresh runner from that checkpoint reproduces the
  probe batch's loss.  Each row also carries ``launches``: the kernel
  launches of that iteration (kernel C on every render on the card) and
  ``plain_calls``, the plain versions run on CUDA tensors (none there).

The port's step is not compiled: an IL row's ``compile`` marks the first
step of a new ``(prompt_T, label_T)`` shape, which on the card pays the
libraries' set-up for that shape.  The default lr is 1e-4, as in the
reference tool (a falling loss from random weights in tens of steps); the
optimizer, the clip and the NaN handling are the production ones.  The
run goes on the card; ``--device cpu`` (or ``main(..., device="cpu")``)
runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device


def _emit(f, row):
    f.write(json.dumps(row) + "\n")
    f.flush()
    print(json.dumps(row), flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _il_config(args):
    from dynam3d_torch.config import apply_opts
    from dynam3d_torch.tools.eval_soak import soak_config

    return apply_opts(soak_config(args.scale), [
        f"train.lr={args.lr}",
        "train.use_waypoint_predictor=false",   # 1-view feed: the geometric fan
    ])


@torch.no_grad()
def _probe_loss(trainable, frozen, cfg, splice, batch, dev) -> float:
    """The loss of ``batch`` from a fresh memory, no update."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime import trainer_vln

    p = trainer_vln.merge_params(trainable, frozen)
    out = policy_mod.perceive(p, cfg, policy_mod.batched_init_state(cfg, 1, dev), batch.rgb,
                              batch.depth, batch.position, batch.heading)
    tl = policy_mod.train_loss(p, cfg, batch.input_ids, batch.text_valid, out.mm_tokens,
                               out.mm_valid, batch.label_ids, batch.label_mask,
                               batch.turn_weight, splice)
    return float(tl.loss.float())


def il_soak(args, dev, out):
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime.feed import FloorplanFeed
    from dynam3d_torch.runtime.vln_loop import VLNTrainer

    cfg = _il_config(args)
    params = policy_mod.init_policy_params(0, cfg, device=dev)

    def feed():
        return FloorplanFeed(rgb_size=cfg.clip.image_size,
                             depth_size=256 if args.scale == "full" else 32, seed=args.seed)

    trainer = VLNTrainer(params, cfg, feed, device=dev)
    rows, shapes = [], set()
    orig_step = trainer._step_fn

    def timed_step(tr, fr, opt, fs, batch):
        key = (int(batch.input_ids.shape[1]), int(batch.label_ids.shape[1]))
        new = key not in shapes
        shapes.add(key)
        _sync(dev)
        t0 = time.perf_counter()
        o = orig_step(tr, fr, opt, fs, batch)
        m = o[3]
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        dt = time.perf_counter() - t0
        rows.append({
            "phase": "il", "it": len(rows), "loss": round(loss, 4),
            "grad_norm": round(gnorm, 3), "nan_skipped": bool(m["skipped"]),
            "step_s": round(dt, 3), "prompt_T": key[0], "label_T": key[1], "compile": new,
        })
        _emit(out, rows[-1])
        return o

    trainer._step_fn = timed_step
    ckpt_dir = os.path.join(args.workdir, "il_ckpt")
    mid = max(args.il_steps // 2, 1)
    probe = {}
    while len(rows) < args.il_steps:
        if len(rows) >= mid and "loss_before" not in probe:
            ckpt_mod.save_checkpoint(ckpt_dir, len(rows), {"trainable": trainer.trainable,
                                                           "opt_state": trainer.opt_state})
            probe["saved_at"] = len(rows)
            batch = _probe_batch(trainer)
            probe["loss_before"] = _probe_loss(trainer.trainable, trainer.frozen, cfg,
                                               trainer.splice_start, batch, dev)
            # the resume check runs in a fresh process, as the reference's
            np.savez(os.path.join(args.workdir, "il_probe.npz"),
                     **{k: v.cpu().numpy() for k, v in batch._asdict().items()})
            with open(os.path.join(args.workdir, "il_probe.json"), "w") as f:
                json.dump({"loss_before": probe["loss_before"], "saved_at": probe["saved_at"],
                           "splice_start": trainer.splice_start}, f)
        # land an episode boundary on the midpoint, so the save above runs
        end = mid if "loss_before" not in probe else args.il_steps
        trainer.train_episode(max_steps=min(end - len(rows), cfg.train.max_traj_len))

    trainer._step_fn = None
    del trainer, orig_step, timed_step, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rc = subprocess.call([sys.executable, "-m", "dynam3d_torch.tools.train_soak",
                          *_child_args(args), "--il-resume-check"])
    if rc:
        _emit(out, {"phase": "il_resume_check", "bit_compatible": False,
                    "error": f"child rc={rc}"})

    losses = [r["loss"] for r in rows if np.isfinite(r["loss"])]
    k = max(len(losses) // 4, 1)
    _emit(out, {
        "phase": "il_summary", "steps": len(rows),
        "loss_first_quartile_mean": round(float(np.mean(losses[:k])), 4),
        "loss_last_quartile_mean": round(float(np.mean(losses[-k:])), 4),
        "nan_skips": sum(r["nan_skipped"] for r in rows),
        "distinct_shapes": len(shapes),
        "compile_steps": sum(r["compile"] for r in rows),
        "steady_step_s_p50": round(float(np.median(
            [r["step_s"] for r in rows if not r["compile"]] or [0.0])), 3),
        "lr": args.lr,
    })
    return rc


def _probe_batch(trainer):
    """A fixed batch of the soak's feed for the resume check."""
    from dynam3d_torch.runtime import trainer_vln

    dev = trainer.device
    obs = trainer.feed_factory().reset()
    ids, tvalid, labels, lmask = trainer._tokenize_full(
        obs.instruction, ["none\n"] * 4, "turn left 2 steps, move 4 steps.")
    return trainer_vln.TrainBatch(
        rgb=torch.from_numpy(np.ascontiguousarray(obs.rgb[None, :1])).to(dev),
        depth=torch.from_numpy(np.asarray(obs.depth[None, :1], np.float32)).to(dev),
        position=torch.from_numpy(np.asarray(obs.position, np.float32)[None]).to(dev),
        heading=torch.tensor([obs.heading], dtype=torch.float32, device=dev),
        input_ids=ids, text_valid=tvalid, label_ids=labels, label_mask=lmask,
        turn_weight=torch.ones(1, dtype=torch.float32, device=dev),
    )


def il_resume_check(args, dev):
    """The fresh process of the IL check: the policy from the same seed,
    the midpoint checkpoint loaded into its trainable tensors, the probe's
    loss."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime import trainer_vln
    from dynam3d_torch.utils.tree import tree_leaves

    cfg = _il_config(args)
    with open(os.path.join(args.workdir, "il_probe.json")) as f:
        meta = json.load(f)
    d = np.load(os.path.join(args.workdir, "il_probe.npz"))
    batch = trainer_vln.TrainBatch(**{k: torch.from_numpy(d[k]).to(dev)
                                      for k in trainer_vln.TrainBatch._fields})
    splice = meta["splice_start"]

    trainable, frozen = trainer_vln.split_params(policy_mod.init_policy_params(0, cfg, device=dev))
    path = ckpt_mod.newest_checkpoint(os.path.join(args.workdir, "il_ckpt"))
    restored = ckpt_mod.load_checkpoint(path)["trainable"]
    with torch.no_grad():
        for dst, src in zip(tree_leaves(trainable), tree_leaves(restored)):
            dst.copy_(src)
    del restored
    loss_after = _probe_loss(trainable, frozen, cfg, splice, batch, dev)
    with open(args.out, "a") as out:
        _emit(out, {
            "phase": "il_resume_check", "resumed_iter": ckpt_mod.checkpoint_step(path),
            "loss_before": meta["loss_before"], "loss_after": loss_after,
            "bit_compatible": loss_after == meta["loss_before"],
        })


def pretrain_soak(args, dev, out):
    from dynam3d_torch.config import apply_opts
    from dynam3d_torch.models.encoders.clip import init_clip_params
    from dynam3d_torch.models.memory3d import init_field_params, init_state
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime import checkpoint as ckpt_mod
    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner, SyntheticFramesDataset
    from dynam3d_torch.tools.eval_soak import soak_config

    cfg = soak_config(args.scale)
    if args.scale == "tiny":
        cfg = apply_opts(cfg, ["fields.view_height=2", "fields.view_width=2"])
    gen = torch.Generator(device=dev).manual_seed(0)
    pr_params = {"fields": init_field_params(gen, cfg.fields, dev),
                 "render": init_render_params(gen, cfg.fields, dev),
                 "clip": init_clip_params(gen, cfg.clip, dev)}
    clip = pr_params["clip"]
    runner = PretrainRunner(dict(pr_params), cfg, seed=args.seed, device=dev)
    depth_size = 256 if args.scale == "full" else 32
    ds = SyntheticFramesDataset(rgb_size=cfg.clip.image_size, depth_size=depth_size,
                                frames=args.frames, seed=args.seed)
    ckpt_dir = os.path.join(args.workdir, "pretrain_ckpt")
    mid = max(args.pretrain_iters // 2, 1)
    probe_scene = SyntheticFramesDataset(rgb_size=cfg.clip.image_size, depth_size=depth_size,
                                         frames=args.frames, seed=1234).sample_scene()

    def probe_loss(r):
        # build_batch draws its synthetic supervision from seed + it: pin it
        # so both sides of the check see the same probe batch
        old_it, r.it = r.it, 10 ** 6
        try:
            batch = r.build_batch(probe_scene, r.params["clip"])
        finally:
            r.it = old_it
        trainable = {"fields": r.params["fields"], "render": r.params["render"]}
        r._ensure_opt(trainable)
        step = r._get_step(posed="intrinsics" in probe_scene)
        m = step(trainable, r._tr_opt, init_state(cfg.fields, dev), batch)[3]
        return float(m["loss"])

    t_hist, loss_before = [], None
    for it in range(args.pretrain_iters):
        kernels.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        hist = runner.run([ds], iters=1)
        _sync(dev)
        dt = time.perf_counter() - t0
        t_hist.append(dt)
        m = hist[-1] if hist else {}
        _emit(out, {
            "phase": "pretrain", "it": it,
            **{k: round(float(v), 4) for k, v in m.items()},
            "iter_s": round(dt, 3),
            "launches": {k: v for k, v in kernels.launches.items() if v},
            "plain_calls": {k: v for k, v in kernels.plain_calls.items() if v},
        })
        if it + 1 == mid:
            ckpt_mod.save_checkpoint(ckpt_dir, it + 1, {"fields": runner.params["fields"],
                                                        "render": runner.params["render"]})
            loss_before = probe_loss(runner)

    template = {"fields": runner.params["fields"], "render": runner.params["render"]}
    loaded = ckpt_mod.load_checkpoint(ckpt_mod.newest_checkpoint(ckpt_dir), template)
    runner2 = PretrainRunner({"clip": clip, **loaded}, cfg, seed=args.seed, device=dev)
    loss_after = probe_loss(runner2)
    _emit(out, {
        "phase": "pretrain_resume_check", "loss_before": loss_before, "loss_after": loss_after,
        "bit_compatible": loss_after == loss_before,
    })
    _emit(out, {
        "phase": "pretrain_summary", "iters": args.pretrain_iters,
        "iter_s_p50": round(float(np.median(t_hist[1:] or t_hist)), 3),
    })


def _child_args(args):
    return ["--out", args.out, "--il-steps", str(args.il_steps),
            "--pretrain-iters", str(args.pretrain_iters), "--frames", str(args.frames),
            "--scale", args.scale, "--lr", str(args.lr), "--seed", str(args.seed),
            "--workdir", args.workdir, "--device", args.device]


def main(argv=None, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--il-steps", type=int, default=60)
    p.add_argument("--pretrain-iters", type=int, default=20)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--scale", default="full", choices=("full", "tiny"))
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "dynam3d_train_soak"))
    p.add_argument("--skip-il", action="store_true")
    p.add_argument("--skip-pretrain", action="store_true")
    p.add_argument("--il-resume-check", action="store_true",
                   help="child mode: run only the IL bit-compat check")
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    args.device = str(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)

    if args.il_resume_check:
        il_resume_check(args, dev)
        return 0
    if not args.skip_il and not args.skip_pretrain:
        # one phase a process: each starts from an empty card
        base = [sys.executable, "-m", "dynam3d_torch.tools.train_soak", *_child_args(args)]
        rc1 = subprocess.call(base + ["--skip-il"])
        rc2 = subprocess.call(base + ["--skip-pretrain"])
        return rc1 or rc2

    rc = 0
    with open(args.out, "a") as out:
        _emit(out, {
            "phase": "meta", "backend": dev.type, "scale": args.scale,
            "il_steps": args.il_steps, "pretrain_iters": args.pretrain_iters, "lr": args.lr,
            "running": "pretrain" if args.skip_il else "il",
        })
        if not args.skip_pretrain:
            pretrain_soak(args, dev, out)
        if not args.skip_il:
            rc = il_soak(args, dev, out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
