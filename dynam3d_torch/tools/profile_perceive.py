"""Stage times of ``policy.perceive`` at full width: where the perception
half of a B = 1 step goes.

    python -m dynam3d_torch.tools.profile_perceive [--reps 6]

Port of ``tools/profile_perceive.py``, on the default ``Dynam3DConfig()``
(CLIP-L/14-336, YOLOv8-seg at FastSAM-x width and imgsz 576, the default
tables).  Stages, one 336² view and its 256² depth:

  clip_grid         : ``preprocess_rgb`` and the CLIP patch grid;
  clip_tower        : the LLaVA tower and projector (``image_features``);
  segmentation      : YOLOv8-seg ``segment_views`` to the patch ids;
  perceive          : the whole ``perceive`` (frustum forgetting on);
  perceive_no_segm  : ``perceive`` with the depth-plane segmenter in place
                      of YOLOv8-seg;
  perceive_no_delete: ``perceive`` with ``delete_old=False``;
  memory_update     : frustum forgetting and ``update_views`` on a random
                      grid and segment map;
  env_tokens        : ``environment_features`` of the state.

Each stage's time is the p50 over ``--reps`` of synchronized host ms
(what a step pays for it, host work included), after one warm call.  One
JSON line a stage, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def stages(params, cfg, dev, seed: int = 0):
    """name -> call, on one view from numpy ``seed`` and a fresh memory."""
    from dynam3d_torch.geom.projection import habitat_to_world
    from dynam3d_torch.models import policy
    from dynam3d_torch.models.encoders import clip as clip_mod
    from dynam3d_torch.models.encoders import yolov8_seg
    from dynam3d_torch.models.encoders.depth_resnet import preprocess_depth
    from dynam3d_torch.models.memory3d import environment_features
    from dynam3d_torch.models.memory3d.state import unstack_state
    from dynam3d_torch.models.memory3d.update import delete_from_frustum, update_views
    from dynam3d_torch.models.vlm import llava as llava_mod

    f = cfg.fields
    H, W = f.input_height, f.input_width
    rng = np.random.default_rng(seed)
    size = cfg.clip.image_size
    rgb = torch.as_tensor(rng.integers(0, 255, (1, 1, size, size, 3), dtype=np.uint8),
                          device=dev)
    depth = torch.as_tensor(rng.uniform(0.05, 0.95, (1, 1, 256, 256)).astype(np.float32),
                            device=dev)
    pos = torch.tensor([[1.0, 1.25, 2.0]], device=dev)
    hd = torch.zeros(1, device=dev)
    state = policy.batched_init_state(cfg, 1, dev)
    depth_plane = dataclasses.replace(cfg, segmenter=dataclasses.replace(
        cfg.segmenter, provider="depth_plane"))

    def pixels():
        px = clip_mod.preprocess_rgb(rgb[0], cfg.clip.image_size)
        return px.to(torch.bfloat16) if cfg.clip.compute_dtype == "bf16" else px

    grid_in = torch.as_tensor(rng.normal(size=(1, H * W, f.fts_dim)).astype(np.float32),
                              device=dev)
    segm_in = torch.as_tensor(rng.integers(0, f.max_segments, (1, H * W)), device=dev)
    d24 = preprocess_depth(policy.nearest_resize_hw(depth[0], H, W)[..., None])[..., 0]
    dfull = preprocess_depth(depth[0, 0][..., None])[..., 0]
    pw = habitat_to_world(pos)[0]

    def memory_update():
        st = delete_from_frustum(unstack_state(state, 0), f, dfull, pw, hd[0])
        return update_views(params["fields"], st, f, d24.reshape(1, H * W), grid_in, segm_in,
                            pw, hd[:1])

    return {
        "clip_grid": lambda: clip_mod.encode_image(params["clip"], cfg.clip, pixels())[1],
        "clip_tower": lambda: llava_mod.image_features(params["llava"], cfg.llava, cfg.clip,
                                                       pixels()),
        "segmentation": lambda: yolov8_seg.segment_views(
            params["yolo"], cfg.segmenter, rgb[0], (H, W), f.max_segments),
        "perceive": lambda: policy.perceive(params, cfg, state, rgb, depth, pos, hd),
        "perceive_no_segm": lambda: policy.perceive(params, depth_plane, state, rgb, depth,
                                                    pos, hd),
        "perceive_no_delete": lambda: policy.perceive(params, cfg, state, rgb, depth, pos, hd,
                                                      delete_old=False),
        "memory_update": memory_update,
        "env_tokens": lambda: environment_features(
            unstack_state(state, 0), pw, hd[0], cfg.eval.instance_distance,
            cfg.eval.zone_distance),
    }


def run(params, cfg, dev, reps: int = 6) -> Dict:
    line = card.card_line(dev)
    out = {}
    for name, fn in stages(params, cfg, dev).items():
        ms = card.step_ms(fn, dev, reps)
        out[name] = card.emit({"tool": "profile_perceive", "stage": name, "p50_ms": ms,
                               "reps": reps}, line)
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models import policy

    cfg = Dynam3DConfig()
    params = policy.init_policy_params(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                                       device=dev)
    return run(params, cfg, dev, args.reps)


if __name__ == "__main__":
    main()
