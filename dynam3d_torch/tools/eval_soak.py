"""Eval soak: full-length episodes through ``vln_loop.evaluate`` on int4
weights with speculative decode.

    python -m dynam3d_torch.tools.eval_soak --out DIR [--episodes 20] [--scale full|tiny]

Port of ``tools/eval_soak.py``.  The feeds alternate ``FloorplanFeed``
(geodesic oracle; even episodes) and ``SyntheticRoomFeed`` (odd episodes,
goals varied by index), each at the CLIP image size and 256² depth (32² at
``--scale tiny``); the weights are random, from seed 0, and Phi-3 is
quantized by ``quantize_phi3(bits=--quant-bits)`` (0 keeps it dense).
Every episode runs ``train.max_traj_len`` steps (``ignore_stop``: random
weights decode stop or unparseable text at once).  ``--world N`` evaluates
as rank 0 of N.  Writes the ``stats_ep`` / ``stats`` files and
``soak_report.json`` (wall time, seconds per episode, ms per step, the
aggregate metrics) into ``--out`` and prints the report.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from dynam3d_torch.device import DeviceLike, resolve_device


def soak_config(scale: str):
    """``full``: the default config with the memory's member caps at 512 /
    128 (the reference benchmark's full-scale config); ``tiny``: the
    reference's tiny slice config."""
    from dynam3d_torch.config import (
        CLIPConfig, Dynam3DConfig, FieldsConfig, LLaVAConfig, Phi3Config, SegmenterConfig,
    )

    if scale == "tiny":
        return Dynam3DConfig(
            fields=FieldsConfig(input_height=4, input_width=4, fts_dim=64, patch_capacity=256,
                                instance_capacity=64, zone_capacity=32, max_segments=8,
                                max_members=32, max_zone_members=16),
            clip=CLIPConfig(image_size=56, patch_size=14, vision_width=64, vision_layers=2,
                            vision_heads=2, embed_dim=64, text_context=16, text_width=32,
                            text_layers=1, text_heads=2, vocab_size=64),
            llava=LLaVAConfig(phi3=Phi3Config(vocab_size=512, hidden_size=64,
                                              intermediate_size=128, num_layers=2, num_heads=2,
                                              num_kv_heads=2, head_dim=32, pad_token_id=260,
                                              end_token_id=257),
                              projector_hidden=64, prefill_bucket=64, max_new_tokens=8),
            segmenter=SegmenterConfig(provider="yolov8", imgsz=32, width_mult=0.125,
                                      depth_mult=0.34, num_protos=8, max_masks=8),
        )
    return Dynam3DConfig(
        fields=FieldsConfig(patch_capacity=32768, instance_capacity=2048, zone_capacity=1024,
                            max_segments=64, max_members=512, max_zone_members=128),
        llava=LLaVAConfig(phi3=Phi3Config(num_layers=32), max_new_tokens=20,
                          prefill_bucket=128),
    )


def soak_feeds(cfg, episodes: int, depth_size: int):
    """The soak's feeds and straight-line gt paths (start -> goal, 8
    points): even episodes ``FloorplanFeed``, odd ``SyntheticRoomFeed``."""
    from dynam3d_torch.runtime.feed import FloorplanFeed, SyntheticRoomFeed

    feeds, gt_paths = [], []
    for i in range(episodes):
        if i % 2 == 0:
            f = FloorplanFeed(rgb_size=cfg.clip.image_size, depth_size=depth_size, seed=i)
        else:
            f = SyntheticRoomFeed(rgb_size=cfg.clip.image_size, depth_size=depth_size, seed=i,
                                  goal=(4.0 + (i % 5), 5.0 + (i % 3)))
        o = f.reset()
        feeds.append(f)
        start = np.asarray(o.position, np.float32)
        goal = np.asarray(f.goal, np.float32)
        gt_paths.append(np.stack([start + t * (goal - start) for t in np.linspace(0, 1, 8)]))
    return feeds, gt_paths


def main(argv=None, device: DeviceLike = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--episodes", type=int, default=20)
    p.add_argument("--scale", default="full", choices=("full", "tiny"))
    p.add_argument("--quant-bits", type=int, default=4, choices=(0, 4, 8))
    p.add_argument("--world", type=int, default=1,
                   help="shard episodes as rank 0 of N")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    import torch

    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime import vln_loop

    cfg = soak_config(args.scale)
    params = policy_mod.init_policy_params(0, cfg, device=dev)
    if args.quant_bits:
        from dynam3d_torch.models.vlm.phi3 import quantize_phi3

        params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=args.quant_bits,
                                                consume=True)
    feeds, gt_paths = soak_feeds(cfg, args.episodes, 256 if args.scale == "full" else 32)

    os.makedirs(args.out, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    agg = vln_loop.evaluate(params, cfg, feeds, gt_paths, out_dir=args.out, ckpt_name="soak",
                            rank=0, world=args.world, ignore_stop=True, device=dev)
    wall = time.perf_counter() - t0
    with open(os.path.join(args.out, f"stats_ep_soak_r0_w{args.world}.json")) as f:
        per_ep = json.load(f)
    steps = int(sum(e["steps_taken"] for e in per_ep.values()))
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "scale": args.scale,
        "weights": "random-init",
        "quant_bits": args.quant_bits,
        "episodes": len(per_ep),
        "world": args.world,
        "steps": steps,
        "wall_s": wall,
        "s_per_episode": wall / max(len(per_ep), 1),
        "ms_per_step": wall * 1e3 / max(steps, 1),
        "metrics": agg,
    }
    with open(os.path.join(args.out, "soak_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
