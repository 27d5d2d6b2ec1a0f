"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through the JAX function and
its port; parameters are made once by the JAX package and converted with
``dynam3d_torch.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from dynam3d_torch import config as tcfg
from dynam3d_torch.convert import params_from_jax

# sections of the reference config tree the port carries
_SECTIONS = ("fields", "clip", "depth", "segmenter", "waypoint", "llava", "action", "eval")
_TRAIN_KEYS = ("lr", "pretrain_lr", "grad_clip_norm", "grad_clip_value", "max_traj_len",
               "iters", "log_every", "seed", "ckpt_dir", "is_requeue", "ml_weight",
               "max_text_len", "recycle_every", "use_waypoint_predictor")


def port_config(jcfg) -> tcfg.Dynam3DConfig:
    """The port's config with the same values as a reference config."""
    d = dataclasses.asdict(jcfg)
    sub = {k: d[k] for k in _SECTIONS}
    sub["train"] = {k: d["train"][k] for k in _TRAIN_KEYS}
    return tcfg.from_dict(sub)


def to_torch(jparams, device="cpu"):
    """Reference parameters -> port parameters (numpy leaves in between)."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device=device)


def slice_config(f32: bool = True, provider: str = "depth_plane"):
    """The end-to-end slice's tiny config with the ``depth_plane``
    segmenter, or with ``provider="yolov8"`` its own tiny YOLOv8-seg;
    ``f32`` pins the aggregation encoders and the CLIP tower to float32,
    where the point of a comparison is the algorithm."""
    from dynam3d_tpu.config import SegmenterConfig
    from tests.test_e2e_slice import tiny_config

    cfg = tiny_config()
    if provider != "yolov8":
        cfg = dataclasses.replace(cfg, segmenter=SegmenterConfig(provider=provider))
    if f32:
        cfg = dataclasses.replace(
            cfg,
            fields=dataclasses.replace(cfg.fields, encoder_dtype="f32"),
            clip=dataclasses.replace(cfg.clip, compute_dtype="f32"),
        )
    return cfg


def np32(t) -> np.ndarray:
    """A torch tensor or JAX array as float32 numpy."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
