"""Reference-weights parity run: torch state dicts -> converters -> an
episode with per-step token dumps and SR / SPL / nDTW; port of
``tools/parity_run.py``.

    python -m dynam3d_torch.tools.parity_run --out runs/parity \\
        --dynam3d dynam3d.pth --llava llava-phi-3-mini.pth --fastsam FastSAM.pth \\
        [--vln ckpt.iter100000.pth] [--episode data/episodes/r2r_ep0.npz]

The reference's assets are not in the repo, so ``--synth`` runs the same
path on full-size random state dicts in the reference's naming
(``runtime.synth_sd``) and requires the conversion to give back every
family exactly (the HF tower's identity tail aside); ``--synth-dir DIR``
also sends each asset through ``torch.save`` and back through the
converter's ``torch.load``.  ``--save-converted DIR`` writes the converted
tree, ``--converted CKPT`` runs from one such file (or one from
``convert_reference_ckpt``) instead of converting, ``--no-episode`` stops
after the conversion.  The configs are the eval soak's
(``eval_soak.soak_config``: ``full`` and ``tiny``, Phi-3's depth set by
``--llm-layers``).  Phi-3 is quantized by ``quantize_phi3(bits=
--quant-bits)`` (0 keeps it dense) before the episode, which runs on the
card (``main(argv, device="cpu")`` on the host).

Written to ``--out``:
  parity_report.json   sources, round-trip max abs diff (``--synth``),
                       parameter count, step times (warm-up: the first
                       step at each padded prompt length; steady: the rest)
  steps_parity.jsonl   per step: action ids, text, position, heading, step
                       seconds, padded prompt length (+ the first step's
                       top-10 prefill logits with ``--dump-logits``)
  stats_ep_parity.json / stats_parity.json
                       per-episode and aggregate metrics
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.tools.convert_reference_ckpt import ASSETS, convert
from dynam3d_torch.tools.eval_soak import soak_config
from dynam3d_torch.utils.tree import tree_leaves

SYNTH_FAMILIES = ("dynam3d", "llava", "clip", "fastsam")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tree_max_diff(a, b) -> float:
    """Largest absolute difference over two trees' leaves in float32; inf
    when their structure or a shape differs."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    worst = 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return float("inf")
        if x.numel():
            worst = max(worst, (x.float() - y.float().to(x.device)).abs().max().item())
    return worst


def with_identity_tail(truth_llava, converted_llava):
    """``truth_llava`` with the converted HF tower's ``ln_post`` / ``proj``:
    the converter fills them with identity (the tower ends at
    ``vision_feature_layer=-2``), so they take no part in a round trip."""
    tv = dict(truth_llava["clip"]["visual"])
    cv = converted_llava["clip"]["visual"]
    tv["ln_post"], tv["proj"] = cv["ln_post"], cv["proj"]
    return {**truth_llava, "clip": {"visual": tv, "text": truth_llava["clip"]["text"]}}


def build_params(args, cfg, report: dict, device: DeviceLike = None):
    """State dicts (files, or synthesized with ``--synth``) -> the converted
    policy tree; with ``--synth`` the round trip must be exact."""
    dev = resolve_device(device)
    paths = {k: getattr(args, k) for k in ASSETS}
    if args.synth:
        from dynam3d_torch.models import policy as policy_mod
        from dynam3d_torch.runtime import synth_sd

        t0 = time.perf_counter()
        truth = policy_mod.init_policy_params(0, cfg, device=dev)
        sds = synth_sd.synth_all(truth, cfg)
        report["synth_assets"] = {k: len(v) for k, v in sds.items()}
        if args.synth_dir:
            # each asset through torch.save and the converter's torch.load
            os.makedirs(args.synth_dir, exist_ok=True)
            for name in SYNTH_FAMILIES:
                if name in sds:
                    paths[name] = os.path.join(args.synth_dir, f"{name}.pth")
                    torch.save(sds[name], paths[name])
            report["synth_dir"] = args.synth_dir
        else:
            paths.update({name: sds.get(name) for name in SYNTH_FAMILIES})
        del sds
        _sync(dev)
        report["synth_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, _, report["converted"] = convert(cfg, paths, dev)
    _sync(dev)
    report["convert_s"] = time.perf_counter() - t0

    if args.synth:
        diffs = {
            "fields": tree_max_diff(truth["fields"], params["fields"]),
            "clip": tree_max_diff(truth["clip"], params["clip"]),
            "llava": tree_max_diff(with_identity_tail(truth["llava"], params["llava"]),
                                   params["llava"]),
        }
        if "yolo" in truth:
            diffs["yolo"] = tree_max_diff(truth["yolo"], params["yolo"])
        report["roundtrip_max_abs_diff"] = {
            k: (v if np.isfinite(v) else "shape-mismatch") for k, v in diffs.items()}
        # every family is exact: f32 leaves round-trip bit for bit, the
        # synthesized BN statistics fold to the identity, and bf16 Phi-3
        # matrices are written and read as bf16
        bad = {k: v for k, v in diffs.items() if v != 0.0}
        if bad:
            raise SystemExit(f"conversion round trip failed: {bad}")
    return params


def _first_logits(runner, params, cfg, state, rgb, depth, pos, hd, ids, tvalid) -> dict:
    """The top 10 logits at the last prompt position of the prefill over
    the spliced prompt (its argmax is the first greedy id), the comparison
    point against a reference-run capture."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.models.vlm import llava as llava_mod
    from dynam3d_torch.models.vlm import phi3 as phi3_mod

    dev = runner.device
    out = policy_mod.perceive(params, cfg, state, rgb, depth, pos, hd)
    emb = llava_mod.splice_embeds(params["llava"], cfg.llava, ids, out.mm_tokens,
                                  runner.splice_start)
    av = policy_mod._attn_valid(tvalid, out.mm_valid, runner.splice_start)
    p3 = cfg.llava.phi3
    total = emb.shape[1] + cfg.llava.max_new_tokens
    cache = phi3_mod.init_cache(p3, 1, total, emb.dtype, device=dev)
    posn = torch.clamp(torch.cumsum(av.to(torch.int64), 1) - 1, min=0)
    # the physical index of the last valid token, as the prefill reads it
    # (the reference's dump takes the count of valid slots less one, which
    # lands earlier whenever instance or zone slots are masked)
    logits, _ = phi3_mod.forward(params["llava"]["phi3"], p3, emb, posn, cache, 0,
                                 phi3_mod.prefill_mask(av, total),
                                 lm_at=phi3_mod._last_valid_idx(av))
    lg = logits[0, 0].float().cpu().numpy()
    return {int(t): round(float(lg[t]), 4) for t in np.argsort(-lg)[:10]}


def run_episode(params, cfg, feed, out_dir: str, max_steps: int, dump_logits: bool = False,
                device: DeviceLike = None) -> dict:
    """A closed-loop episode on ``feed`` with per-step dumps."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime import metrics as metrics_mod
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import STOP
    from dynam3d_torch.utils.actions import EpisodeActionState, parse_action

    dev = resolve_device(device)
    runner = EpisodeRunner(params, cfg, device=dev)
    state = policy_mod.batched_init_state(cfg, 1, dev)
    obs = feed.reset()
    act = EpisodeActionState()
    positions = [np.asarray(obs.position, np.float32)]
    # a step is a steady sample only when its padded prompt length was seen
    # before (the history grows over the first steps, then saturates)
    seen_shapes: set = set()
    warmup, steady = [], []
    n_steps = 0
    prev_gen = None
    with open(os.path.join(out_dir, "steps_parity.jsonl"), "w") as sf:
        for stepk in range(max_steps):
            rgb, depth, pos = (t[None] for t in runner._upload(obs))
            hd = torch.tensor([obs.heading], dtype=torch.float32, device=dev)
            ids, tvalid, _ = runner._prompt_ids([obs.instruction], [act.history_actions])
            _sync(dev)
            t0 = time.perf_counter()
            before = state
            state, gen_dev = runner._full_step(state, rgb, depth, pos, hd, ids, tvalid, prev_gen)
            gen = gen_dev.cpu().numpy()
            dt = time.perf_counter() - t0
            prev_gen = gen_dev
            shape_key = int(ids.shape[1])
            is_steady = shape_key in seen_shapes
            if is_steady:
                steady.append(dt)
            else:
                seen_shapes.add(shape_key)
                warmup.append((stepk, shape_key, dt))
            text = runner.tok.decode(gen[0])
            cut = text.find("<|end|>")
            if cut != -1:
                text = text[:cut]
            rec = {"step": stepk, "action_ids": [int(x) for x in gen[0]], "action_text": text,
                   "position": [float(x) for x in obs.position], "heading": float(obs.heading),
                   "step_s": dt, "prompt_padded_len": shape_key, "steady": is_steady}
            if dump_logits and stepk == 0:
                # the step's own prefill: on the memory before the step (the
                # reference perceives the view a second time, into the memory
                # the step already updated)
                rec["logits_top10"] = _first_logits(runner, params, cfg, before, rgb, depth, pos,
                                                    hd, ids, tvalid)
            sf.write(json.dumps(rec) + "\n")
            act.push_history(text + "\n")
            action = parse_action(text, cfg.action)
            n_steps = stepk + 1
            if action == STOP or stepk == max_steps - 1:
                feed.step(STOP)
                break
            obs, done, _ = feed.step(action)
            positions.append(np.asarray(obs.position, np.float32))
            if done:
                break

    pred_path = np.stack(positions)
    dists = np.asarray([feed.oracle_distance(p) for p in pred_path], np.float32)
    gt = getattr(feed, "gt_locations", None)
    gt = pred_path if gt is None else np.asarray(gt, np.float32)
    ep = metrics_mod.episode_metrics(pred_path, dists, gt, n_steps,
                                     success_distance=cfg.eval.success_distance)
    agg = metrics_mod.aggregate([ep])
    with open(os.path.join(out_dir, "stats_ep_parity.json"), "w") as f:
        json.dump({"0": ep}, f, indent=2)
    with open(os.path.join(out_dir, "stats_parity.json"), "w") as f:
        json.dump(agg, f, indent=2)
    return {
        "steps": n_steps,
        "warmup_steps": [{"step": s, "prompt_padded_len": k, "step_s": t} for s, k, t in warmup],
        "first_step_s": warmup[0][2] if warmup else 0.0,
        "steady_step_ms": 1e3 * float(np.median(steady)) if steady else None,
        "steady_samples": len(steady),
        "metrics": agg,
    }


def main(argv=None, device: DeviceLike = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    for name in ASSETS:
        p.add_argument(f"--{name}", default=None)
    p.add_argument("--synth", action="store_true",
                   help="synthesize full-size random reference state dicts")
    p.add_argument("--synth-dir", default=None,
                   help="with --synth: torch.save the assets here and load them back")
    p.add_argument("--episode", default=None, help="recorded episode .npz (RecordedEpisodeFeed)")
    p.add_argument("--save-converted", default=None,
                   help="save the converted policy tree as ckpt.iter0 here")
    p.add_argument("--converted", default=None,
                   help="run from a saved converted checkpoint instead of converting")
    p.add_argument("--no-episode", action="store_true", help="stop after the conversion")
    p.add_argument("--scale", default="full", choices=("full", "tiny"))
    p.add_argument("--llm-layers", type=int, default=None,
                   help="Phi-3 depth (default: the scale's, 32 at full, 2 at tiny)")
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--quant-bits", type=int, default=4, choices=(0, 4, 8))
    p.add_argument("--dump-logits", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    os.makedirs(args.out, exist_ok=True)
    cfg = soak_config(args.scale, args.llm_layers)
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "scale": args.scale}
    if args.converted:
        from dynam3d_torch.runtime.checkpoint import load_to_device

        payload = load_to_device(args.converted, dev)
        params = payload["params"] if "params" in payload else payload
        report["converted"] = args.converted
    else:
        params = build_params(args, cfg, report, dev)
    report["policy_params_m"] = sum(int(x.numel()) for x in tree_leaves(params)) / 1e6

    if args.save_converted:
        from dynam3d_torch.runtime.checkpoint import save_checkpoint

        report["saved_converted"] = save_checkpoint(args.save_converted, 0, {"params": params})

    if not args.no_episode:
        if args.quant_bits:
            from dynam3d_torch.models.vlm.phi3 import quantize_phi3

            params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"],
                                                    bits=args.quant_bits, consume=True)
            report["quant_bits"] = args.quant_bits
        if args.episode:
            from dynam3d_torch.runtime.feed import RecordedEpisodeFeed

            feed = RecordedEpisodeFeed(args.episode)
            report["feed"] = args.episode
        else:
            from dynam3d_torch.runtime.feed import SyntheticRoomFeed

            feed = SyntheticRoomFeed(rgb_size=cfg.clip.image_size,
                                     depth_size=256 if args.scale == "full" else 32, views=1)
            report["feed"] = "synthetic"
        report.update(run_episode(params, cfg, feed, args.out, args.steps,
                                  dump_logits=args.dump_logits, device=dev))
    with open(os.path.join(args.out, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
