"""Command-line entry of the port: train / eval / inference dispatch.

    python -m dynam3d_torch.run --run-type eval --exp_name demo
    python -m dynam3d_torch.run --run-type inference --exp_name demo
    python -m dynam3d_torch.run --run-type train --exp_name il train.iters=1000
    python -m dynam3d_torch.run --run-type train --trainer SS-ETP --exp_name pre
    python -m dynam3d_torch.run --exp-config cfg.json --run-type eval train.max_traj_len=3

Port of ``run.py``: a config file (JSON or YAML) with ``dotted.key=value``
overrides, the two trainers by their registry names and the three run
types.  Every run writes its log to ``data/logs/running_log/{exp_name}.log``;
eval writes ``data/eval/{exp_name}/``, inference
``data/eval/{exp_name}_preds.json``, training its checkpoints under
``train.ckpt_dir`` (all relative to the working directory).  The rank and
world size come from torchrun's ``RANK`` / ``WORLD_SIZE``: eval and
inference shard the episodes by rank; training at a world size above one
is not ported yet and raises.  The run goes on the card; ``main(...,
device="cpu")`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
from typing import Dict

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device

TRAINER_REGISTRY: Dict[str, str] = {
    # registry name -> module path (the reference's trainer names)
    "Dynam3D": "dynam3d_torch.runtime.vln_loop",
    "SS-ETP": "dynam3d_torch.runtime.trainer_3dff",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynam3d_torch launcher")
    p.add_argument("--exp_name", type=str, default="test", help="experiment id")
    p.add_argument("--run-type", choices=["train", "eval", "inference"], required=True)
    p.add_argument("--exp-config", type=str, default=None,
                   help="config file (json/yaml); defaults apply if omitted")
    p.add_argument("--trainer", type=str, default="Dynam3D", choices=sorted(TRAINER_REGISTRY))
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("opts", nargs=argparse.REMAINDER, help="dotted.key=value config overrides")
    return p


def setup_logging(exp_name: str, log_dir: str = "data/logs/running_log") -> logging.Logger:
    """The ``dynam3d_torch`` logger writing to ``{log_dir}/{exp_name}.log``
    and to stderr; the handlers of an earlier call are closed and replaced,
    so a process that runs ``main`` several times logs each line once."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger("dynam3d_torch")
    logger.setLevel(logging.INFO)
    for h in [h for h in logger.handlers if getattr(h, "_dynam3d_run", False)]:
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(os.path.join(log_dir, f"{exp_name}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    for h in (fh, logging.StreamHandler()):
        h._dynam3d_run = True
        logger.addHandler(h)
    return logger


def seed_everything(seed: int, rank: int = 0) -> None:
    """Per-rank seed offset of Python's and numpy's global generators."""
    random.seed(seed + rank)
    np.random.seed(seed + rank)


def main(argv=None, device: DeviceLike = None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    from dynam3d_torch.config import Dynam3DConfig, apply_opts, load

    cfg = load(args.exp_config) if args.exp_config else Dynam3DConfig()
    if args.opts:
        cfg = apply_opts(cfg, [o for o in args.opts if "=" in o])

    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.run_type == "train" and world > 1:
        raise NotImplementedError(
            f"training at WORLD_SIZE={world}: data-parallel training is not ported yet "
            "(ROADMAP Queue 1, item 7)")

    logger = setup_logging(args.exp_name)
    seed_everything(args.seed or cfg.train.seed, rank)
    logger.info("exp=%s type=%s trainer=%s rank=%d/%d device=%s",
                args.exp_name, args.run_type, args.trainer, rank, world, dev)

    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    ckpt_dir = args.ckpt_dir or cfg.train.ckpt_dir

    def feed_factory():
        return SyntheticRoomFeed(seed=random.randint(0, 1 << 30))

    def train_feed_factory():
        # 12-view depth panorama at the depth encoder's input size for the
        # frozen waypoint predictor; the policy sees view 0 only
        return SyntheticRoomFeed(views=12, depth_size=cfg.depth.input_size,
                                 seed=random.randint(0, 1 << 30))

    if args.trainer == "Dynam3D":
        from dynam3d_torch.runtime.vln_loop import VLNTrainer, evaluate, inference

        params = policy_mod.init_policy_params(cfg.train.seed, cfg, device=dev)
        if args.run_type == "train":
            trainer = VLNTrainer(params, cfg, train_feed_factory, rank=rank, world=world,
                                 device=dev)
            start = trainer.resume(ckpt_dir) if cfg.train.is_requeue else 0
            trainer.train(cfg.train.iters - start, ckpt_dir=ckpt_dir)
        elif args.run_type == "eval":
            from dynam3d_torch.runtime.feed import FloorplanFeed

            # convex rooms and non-convex floorplans, so the geodesic
            # metrics see both geometries
            feeds = [feed_factory() for _ in range(6)] + [FloorplanFeed(seed=s) for s in (1, 2)]
            gt = [np.zeros((2, 3), np.float32) for _ in feeds]
            agg = evaluate(params, cfg, feeds, gt, rank=rank, world=world,
                           out_dir=f"data/eval/{args.exp_name}", device=dev)
            logger.info("eval: %s", json.dumps(agg))
        else:
            feeds = [feed_factory() for _ in range(4)]
            out_path = f"data/eval/{args.exp_name}_preds.json"
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            inference(params, cfg, feeds, [str(i) for i in range(len(feeds))],
                      out_path=out_path, rank=rank, world=world, device=dev)
    else:  # SS-ETP pretraining: one walk corpus and two posed-frame corpora
        from dynam3d_torch.models.encoders.clip import init_clip_params
        from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
        from dynam3d_torch.models.memory3d import init_field_params
        from dynam3d_torch.models.render.nerf import init_render_params
        from dynam3d_torch.models.waypoint.trm import init_waypoint_params
        from dynam3d_torch.runtime.logging import MetricsLogger
        from dynam3d_torch.runtime.pretrain_loop import (
            PretrainRunner, SyntheticFramesDataset, WalkDriver, synthetic_supervision,
        )

        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        pre_params = {
            "fields": init_field_params(gen, cfg.fields, dev),
            "render": init_render_params(gen, cfg.fields, dev),
            "clip": init_clip_params(gen, cfg.clip, dev),
            "depth_enc": init_depth_params(gen, cfg.depth, device=dev),
            "waypoint": init_waypoint_params(gen, cfg.waypoint,
                                             depth_feat_dim=feature_dim(cfg.depth), device=dev),
        }
        runner = PretrainRunner(pre_params, cfg, seed=cfg.train.seed + rank, device=dev)
        walk_feed = SyntheticRoomFeed(views=12, depth_size=cfg.depth.input_size,
                                      seed=random.randint(0, 1 << 30))
        datasets = [
            WalkDriver(
                walk_feed,
                synthetic_supervision(cfg.train.seed, cfg.fields.fts_dim),
                max_len=cfg.train.pretrain_traj_len,
                seed=cfg.train.seed + rank,
                waypoint_aug=cfg.train.waypoint_aug,
                teacher_prob=cfg.train.sample_ratio * 0.5,
            ),
            SyntheticFramesDataset(seed=cfg.train.seed),
            SyntheticFramesDataset(seed=cfg.train.seed + 1, posed=True),
        ]
        mlogger = MetricsLogger(f"data/logs/{args.exp_name}")
        try:
            runner.run(datasets, iters=cfg.train.iters, logger=mlogger, ckpt_dir=ckpt_dir,
                       log_every=cfg.train.log_every)
        finally:
            mlogger.close()


if __name__ == "__main__":
    main()
