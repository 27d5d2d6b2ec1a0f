"""Random weights from ``--seed``, made on the card in a few large draws.

The benchmark makes the weights and hands the same tree to both sides: the
program's set-up consumes one tree, and the reference makes the same tree
again after the window.  The tree has the layout the program takes
(``{"w": [in, out], "b"}`` dense layers, OIHW convolutions, Phi-3's fused
``qkv`` and ``gate_up``); each leaf keeps its own scale: normal std 0.02
for Phi-3, ``1/sqrt(fan_in)`` dense layers, He-normal convolutions, ones
and zeros for norms and biases.  Every ``torch.randn`` below is served from
a few chunked normal draws of one ``torch.Generator`` on the device, so a
tree of four billion values takes some twenty generator calls, and the
same seed gives the same tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode

CHUNK = {"cuda": 1 << 28, "cpu": 1 << 20}    # normals per draw (1 GiB of f32 on the card)
REG_MAX = 16                                 # YOLOv8's DFL bins

Params = Dict[str, Any]


class _ChunkedNormals(TorchFunctionMode):
    """Serves ``torch.randn(..., generator=g)`` from chunked draws of one
    generator; other calls pass through."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        super().__init__()
        self.gen, self.device = gen, device
        self.buf = torch.empty(0, device=device)
        self.at = 0
        self.draws = 0

    def _take(self, n: int) -> torch.Tensor:
        if n > self.buf.numel() - self.at:
            self.buf = torch.randn(max(n, CHUNK.get(self.device.type, 1 << 20)),
                                   generator=self.gen, device=self.device)
            self.at = 0
            self.draws += 1
        out = self.buf[self.at: self.at + n]
        self.at += n
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.randn and "generator" in kwargs:
            shape = args[0] if len(args) == 1 and isinstance(args[0], (tuple, list)) else args
            shape = tuple(int(s) for s in shape)
            n = 1
            for s in shape:
                n *= s
            return self._take(n).view(shape).clone()
        return func(*args, **kwargs)


def make_tree(init, seed: int, dev: torch.device, *args, **kwargs) -> Dict[str, Any]:
    """``init(generator, *args, **kwargs)`` with its normal draws chunked."""
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    mode = _ChunkedNormals(gen, dev)
    with mode:
        tree = init(gen, *args, **kwargs)
    del mode.buf
    return tree


# --- leaves -------------------------------------------------------------------

def _randn(g, dev, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=g, device=dev)


def _dense(g, dev, d_in: int, d_out: int) -> Params:
    return {"w": _randn(g, dev, d_in, d_out) / math.sqrt(d_in),
            "b": torch.zeros(d_out, device=dev)}


def _ln(dev, d: int) -> Params:
    return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}


def _mlp2(g, dev, d_in: int, d_hidden: int, d_out: int) -> Params:
    return {"fc1": _dense(g, dev, d_in, d_hidden), "ln": _ln(dev, d_hidden),
            "fc2": _dense(g, dev, d_hidden, d_out)}


def _encoder(g, dev, d: int, n_layers: int) -> Params:
    """Post-norm transformer encoder layers with a final norm."""
    layers = [{"attn": {"qkv": _dense(g, dev, d, 3 * d), "out": _dense(g, dev, d, d)},
               "ln1": _ln(dev, d), "ff1": _dense(g, dev, d, 4 * d),
               "ff2": _dense(g, dev, 4 * d, d), "ln2": _ln(dev, d)} for _ in range(n_layers)]
    return {"layers": layers, "final_ln": _ln(dev, d)}


# --- modules ------------------------------------------------------------------

def clip_tower(g, dev, c) -> Params:
    """CLIP's image tower (the text tower is on no served path)."""
    vw, s = c.vision_width, c.vision_width ** -0.5

    def block():
        return {"attn": {"qkv": _dense(g, dev, vw, 3 * vw), "out": _dense(g, dev, vw, vw)},
                "ln1": _ln(dev, vw), "ln2": _ln(dev, vw),
                "fc1": _dense(g, dev, vw, 4 * vw), "fc2": _dense(g, dev, 4 * vw, vw)}

    return {"visual": {
        "conv1_w": _randn(g, dev, c.patch_size ** 2 * 3, vw) * s,
        "class_embedding": s * _randn(g, dev, vw),
        "positional_embedding": s * _randn(g, dev, c.grid ** 2 + 1, vw),
        "ln_pre": _ln(dev, vw),
        "transformer": {"blocks": [block() for _ in range(c.vision_layers)]},
        "ln_post": _ln(dev, vw),
        "proj": s * _randn(g, dev, vw, c.embed_dim)}}


def phi3(g, dev, p3, dtype=torch.bfloat16) -> Params:
    D, q = p3.hidden_size, p3.num_heads * p3.head_dim
    kv = p3.num_kv_heads * p3.head_dim

    def w(d_in, d_out):
        return (_randn(g, dev, d_in, d_out) * 0.02).to(dtype)

    return {"embed_tokens": w(p3.vocab_size, D),
            "layers": [{"input_ln": torch.ones(D, device=dev), "qkv": w(D, q + 2 * kv),
                        "o": w(q, D), "post_ln": torch.ones(D, device=dev),
                        "gate_up": w(D, 2 * p3.intermediate_size),
                        "down": w(p3.intermediate_size, D)} for _ in range(p3.num_layers)],
            "final_ln": torch.ones(D, device=dev),
            "lm_head": w(D, p3.vocab_size)}


def fields(g, dev, f) -> Params:
    d = f.fts_dim
    return {"patch_pos_mlp": _mlp2(g, dev, 7, d, d),
            "p2i_agg_token": d ** -0.5 * _randn(g, dev, 1, d),
            "p2i_encoder": _encoder(g, dev, d, 2),
            "inst_pos_mlp": _mlp2(g, dev, 4, d, d),
            "i2z_agg_token": d ** -0.5 * _randn(g, dev, 1, d),
            "i2z_encoder": _encoder(g, dev, d, 2),
            "merge_disc": {"fc1": _dense(g, dev, 2 * d + 3, 4 * d), "ln": _ln(dev, 4 * d),
                           "fc2": _dense(g, dev, 4 * d, 2)}}


def yolo_channels(width: float, max_ch: int = 512):
    return [max(16, int(round(c * width / 16)) * 16) if c * width >= 16 else int(c * width)
            for c in (64, 128, 256, 512, max_ch)]


def yolov8(g, dev, seg) -> Params:
    """YOLOv8-seg: backbone, PAN neck, prototypes and three detect heads."""
    def conv(cin, cout, k=3):
        return {"w": _randn(g, dev, cout, cin, k, k) * (2.0 / (k * k * cin)) ** 0.5,
                "b": torch.zeros(cout, device=dev)}

    def c2f(cin, cout, n):
        h = cout // 2
        return {"cv1": conv(cin, 2 * h, 1),
                "m": [{"cv1": conv(h, h), "cv2": conv(h, h)} for _ in range(n)],
                "cv2": conv((2 + n) * h, cout, 1)}

    c1, c2, c3, c4, c5 = yolo_channels(seg.width_mult)
    n1, n2, n3, n4 = seg.depth_n
    p = {"stem": conv(3, c1), "down1": conv(c1, c2), "c2f1": c2f(c2, c2, n1),
         "down2": conv(c2, c3), "c2f2": c2f(c3, c3, n2), "down3": conv(c3, c4),
         "c2f3": c2f(c4, c4, n3), "down4": conv(c4, c5), "c2f4": c2f(c5, c5, n4),
         "sppf": {"cv1": conv(c5, c5 // 2, 1), "cv2": conv(c5 * 2, c5, 1)},
         "neck1": c2f(c5 + c4, c4, n1), "neck2": c2f(c4 + c3, c3, n1), "pan1": conv(c3, c3),
         "neck3": c2f(c3 + c4, c4, n1), "pan2": conv(c4, c4), "neck4": c2f(c4 + c5, c5, n1),
         "proto": {"cv1": conv(c3, c3), "cv2": conv(c3, c3), "cv3": conv(c3, seg.num_protos, 1)},
         "det": []}
    cbox, ccls, cm = max(16, 4 * REG_MAX), max(c3, 16), max(c3 // 4, seg.num_protos)
    for cf in (c3, c4, c5):
        p["det"].append({"box0": conv(cf, cbox), "box1": conv(cbox, cbox),
                         "box2": conv(cbox, 4 * REG_MAX, 1),
                         "cls0": conv(cf, ccls), "cls1": conv(ccls, ccls), "cls2": conv(ccls, 1, 1),
                         "m0": conv(cf, cm), "m1": conv(cm, cm), "m2": conv(cm, seg.num_protos, 1)})
    return p


def _policy(g, cfg, dev) -> Params:
    d, dl = cfg.fields.fts_dim, cfg.llava.phi3.hidden_size
    tree = {
        "fields": fields(g, dev, cfg.fields),
        "clip": clip_tower(g, dev, cfg.clip),
        "llava": {"clip": clip_tower(g, dev, cfg.clip),
                  "projector": {"fc1": _dense(g, dev, cfg.clip.vision_width,
                                              cfg.llava.projector_hidden),
                                "fc2": _dense(g, dev, cfg.llava.projector_hidden, dl)},
                  "phi3": phi3(g, dev, cfg.llava.phi3)},
        "patch_pos_emb": _mlp2(g, dev, 6, dl, dl),
        "inst_pos_emb": _mlp2(g, dev, 3, d, d),
        "zone_pos_emb": _mlp2(g, dev, 3, d, d),
        "inst_proj": _mlp2(g, dev, 2 * d, dl, dl),
        "zone_proj": _mlp2(g, dev, 2 * d, dl, dl),
    }
    if cfg.segmenter.provider == "yolov8":
        tree["yolo"] = yolov8(g, dev, cfg.segmenter)
    return tree


def policy_params(seed: int, ref_cfg, device: torch.device) -> Dict[str, Any]:
    """The VLN policy's tree (bf16 Phi-3, the encoders, the memory)."""
    return make_tree(_policy, seed, device, ref_cfg, device)
