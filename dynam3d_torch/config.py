"""Configuration of the PyTorch port: the dataclasses its paths read.

An own copy of the reference package's config tree (same field names,
defaults and sections), overridable from JSON / YAML files and
``dotted.key=value`` options as the reference's ``config.py`` is.  The port
never imports the JAX package, so these classes are kept here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class FieldsConfig:
    """3D memory ("Feature Fields") hyperparameters and table capacities."""

    input_hfov: float = 90.0
    input_vfov: float = 90.0
    input_height: int = 24          # patch grid height (24x24 per view)
    input_width: int = 24
    fts_dim: int = 768

    zone_x_length: float = 2.0      # zone cell 2x2x2 m
    zone_y_length: float = 2.0
    zone_z_length: float = 2.0

    deleted_frustum_distance: float = 3.0
    frustum_depth_slack: float = 0.1

    num_proposal_instances: int = 2

    patch_capacity: int = 32768
    instance_capacity: int = 2048
    zone_capacity: int = 1024
    max_segments: int = 64
    max_members: int = 4096
    max_zone_members: int = 256

    #: matmul dtype of the patch->instance / instance->zone aggregation
    #: encoders ("bf16" serving, "f32" for bit-close comparisons)
    encoder_dtype: str = "bf16"

    # renderer fields (3DFF pretraining path)
    near: float = 0.0
    far: float = 10.0
    view_hfov: float = 90.0
    view_vfov: float = 90.0
    view_height: int = 12
    view_width: int = 12
    search_radius: float = 1.0
    search_num: int = 4
    mlp_net_layers: int = 4
    mlp_net_width: int = 768
    n_samples: int = 501
    n_importance: int = 8
    knn_tile: int = 1024
    knn_band: int = 64

    tombstone: float = -10000.0


@dataclass(frozen=True)
class CLIPConfig:
    """OpenAI CLIP ViT-L/14@336px."""

    image_size: int = 336
    patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    embed_dim: int = 768
    text_context: int = 77
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    vocab_size: int = 49408
    #: vision-tower matmul dtype ("bf16" serving, "f32" for comparisons)
    compute_dtype: str = "bf16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class DepthEncoderConfig:
    """DDPPO GroupNorm ResNet-50 depth encoder of the waypoint predictor."""

    input_size: int = 256
    output_size: int = 128
    base_planes: int = 32
    ngroups: int = 16
    spatial_output: bool = True


@dataclass(frozen=True)
class SegmenterConfig:
    """FastSAM / YOLOv8-seg "segment everything".

    ``provider`` selects the segmentation source of ``perceive``:
    ``"yolov8"`` (default: the learned FastSAM-x provider,
    ``models/encoders/yolov8_seg.py``, conf 0.4 / iou 0.8 / imgsz 576) or
    ``"depth_plane"`` (the geometric provider, ``models/segmenter.py``)."""

    provider: str = "yolov8"
    imgsz: int = 576
    conf: float = 0.4
    iou: float = 0.8
    max_masks: int = 64
    width_mult: float = 1.25        # FastSAM-x = YOLOv8x-seg scaling
    depth_mult: float = 1.0
    num_protos: int = 32

    def depth_layers(self) -> tuple:
        """ultralytics depth scaling: base (3,6,6,3) x depth_mult, min 1."""
        return tuple(
            max(1, round(n * self.depth_mult)) for n in (3, 6, 6, 3)
        )


@dataclass(frozen=True)
class WaypointConfig:
    """Frozen TRM waypoint predictor: 12 views -> 120 angles x 12 distance
    bins, at most ``max_candidates`` NMS peaks."""

    hidden_dim: int = 768
    num_angles: int = 120
    num_imgs: int = 12
    n_classes: int = 12
    trm_layers: int = 2
    trm_neighbor: int = 1
    heatmap_offset: int = 5
    num_attention_heads: int = 12
    max_candidates: int = 5
    nms_sigma: Tuple[float, float] = (7.0, 5.0)


@dataclass(frozen=True)
class Phi3Config:
    """Phi-3-mini-4k decoder."""

    vocab_size: int = 32064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 96
    rope_theta: float = 10000.0
    max_position: int = 4096
    rms_eps: float = 1e-5
    pad_token_id: int = 32000
    end_token_id: int = 32007
    image_token_id: int = 32038


@dataclass(frozen=True)
class LLaVAConfig:
    """LLaVA-Phi-3-mini: CLIP-L/14-336 tower + 2-layer projector + Phi-3."""

    phi3: Phi3Config = field(default_factory=Phi3Config)
    vision_feature_layer: int = -2
    projector_hidden: int = 3072
    max_new_tokens: int = 20
    prefill_bucket: int = 128


@dataclass(frozen=True)
class ActionConfig:
    angle_per_step_deg: float = 15.0
    distance_per_step: float = 0.25
    max_turn_steps: int = 4
    history_len: int = 4


@dataclass(frozen=True)
class TrainConfig:
    """``lr`` and ``grad_clip_norm`` set the VLN imitation-learning
    optimizer (Adafactor after a clip to global norm); ``pretrain_lr`` and
    ``grad_clip_value`` the 3DFF pretraining one (AdamW after a per-value
    clip).  ``max_traj_len`` caps an episode.  ``iters``, ``ckpt_dir``,
    ``log_every`` and ``is_requeue`` set ``VLNTrainer.run``."""

    lr: float = 1e-6
    pretrain_lr: float = 1e-5
    grad_clip_norm: float = 10.0
    grad_clip_value: float = 10.0
    max_traj_len: int = 50
    pretrain_traj_len: int = 5
    iters: int = 100000
    log_every: int = 500
    batch_size: int = 1            # the reference's field; no path of the port reads it
    seed: int = 0
    ckpt_dir: str = "data/checkpoints"
    is_requeue: bool = False        # resume from the newest checkpoint by mtime
    ml_weight: float = 1.0          # weight of the logged IL loss
    waypoint_aug: bool = True       # walk waypoints sampled from the heatmap
    sample_ratio: float = 1.0       # twice the walk's teacher share
    max_text_len: int = 2000        # instruction character cap
    recycle_every: int = 20         # episodes between feed rebuilds
    use_waypoint_predictor: bool = True  # teacher candidates from the TRM


@dataclass(frozen=True)
class EvalConfig:
    success_distance: float = 3.0
    max_infer_positions: int = 500
    fast_eval_stride: int = 5
    instance_distance: float = 5.0
    zone_distance: float = 100.0


@dataclass(frozen=True)
class MeshConfig:
    """Device layout: data-parallel ranks times tensor-parallel shards."""

    dp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp


@dataclass(frozen=True)
class Dynam3DConfig:
    fields: FieldsConfig = field(default_factory=FieldsConfig)
    clip: CLIPConfig = field(default_factory=CLIPConfig)
    depth: DepthEncoderConfig = field(default_factory=DepthEncoderConfig)
    segmenter: SegmenterConfig = field(default_factory=SegmenterConfig)
    waypoint: WaypointConfig = field(default_factory=WaypointConfig)
    llava: LLaVAConfig = field(default_factory=LLaVAConfig)
    action: ActionConfig = field(default_factory=ActionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def _replace_nested(cfg: Any, dotted: str, value: Any) -> Any:
    head, _, rest = dotted.partition(".")
    names = {f.name for f in dataclasses.fields(cfg)}
    if head not in names:
        raise KeyError(f"unknown config key: {head!r} on {type(cfg).__name__}")
    if not rest:
        if isinstance(value, str):
            value = _coerce(value, getattr(cfg, head))
        return dataclasses.replace(cfg, **{head: value})
    sub = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _replace_nested(sub, rest, value)})


def _coerce(text: str, prev: Any) -> Any:
    """A string value read as the type of the field's current value: bool
    ("1", "true", "yes", "on"), int, float, or a tuple split on ","."""
    if isinstance(prev, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(prev, int):
        return int(text)
    if isinstance(prev, float):
        return float(text)
    if isinstance(prev, tuple):
        return tuple(type(prev[0])(t) for t in text.split(","))
    return text


def apply_opts(cfg: Dynam3DConfig, opts: list) -> Dynam3DConfig:
    """Apply ``dotted.key=value`` options, e.g. ``train.iters=5``."""
    for opt in opts:
        key, _, val = opt.partition("=")
        cfg = _replace_nested(cfg, key.strip(), val.strip())
    return cfg


def from_dict(d: dict, base: Optional[Dynam3DConfig] = None) -> Dynam3DConfig:
    """Build a config from a (possibly partial) nested dict, e.g.
    ``dataclasses.asdict`` of another config tree with the same names."""
    cfg = base or Dynam3DConfig()

    def rec(prefix: str, node: Any):
        nonlocal cfg
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}.{k}" if prefix else k, v)
        else:
            cfg = _replace_nested(cfg, prefix, node)

    rec("", d)
    return cfg


def load(path: str, opts: Optional[list] = None) -> Dynam3DConfig:
    """A config from a JSON file, or YAML (``.yaml`` / ``.yml``, read with
    PyYAML), then ``opts`` as :func:`apply_opts` takes them."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        d = yaml.safe_load(text)
    else:
        d = json.loads(text)
    cfg = from_dict(d or {})
    if opts:
        cfg = apply_opts(cfg, opts)
    return cfg
