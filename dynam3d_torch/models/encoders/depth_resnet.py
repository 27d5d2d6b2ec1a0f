"""DDPPO depth encoder: GroupNorm ResNet-50 over 256 x 256 depth maps;
port of ``models/encoders/depth_resnet.py`` (``preprocess_depth``,
``encode_depth``, ``init_depth_params``) on ``F.conv2d``.

conv 7x7/2 -> GN -> ReLU -> max pool 3x3/2 (XLA "SAME" windows) -> four
bottleneck stages (3, 4, 6, 3 blocks) -> 3x3 compression conv to 32
channels -> GN(1) -> ReLU, flattened in (H, W, C) order as the reference
flattens its NHWC map.  Convolution weights are OIHW here (the reference
keeps HWIO; ``convert.conv_params_from_jax`` lays them out once).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from dynam3d_torch.config import DepthEncoderConfig
from dynam3d_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]

_STAGES = (3, 4, 6, 3)


def preprocess_depth(depth: torch.Tensor,
                     depth_scale: Tuple[float, float] = (0.0, 10.0)) -> torch.Tensor:
    """``[B, H, W, 1]`` normalized depth -> metric depth; zero (invalid)
    pixels take the maximum of their column first."""
    lo, hi = depth_scale
    cmax = depth.amax(dim=1, keepdim=True)
    d = torch.where(depth == 0, cmax.expand_as(depth), depth)
    return lo + d * (hi - lo)


def _gn(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x.to(torch.float32), groups, p["scale"], p["bias"], eps).to(x.dtype)


def _conv(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = p["w"]
    return F.conv2d(x.to(torch.float32), w.to(torch.float32), stride=stride,
                    padding=(w.shape[-1] - 1) // 2).to(x.dtype)


def _maxpool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``lax.reduce_window`` max with "SAME" padding: the extra row and
    column go after the map."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


def _bottleneck(p: Params, x: torch.Tensor, stride: int, ng: int) -> torch.Tensor:
    out = F.relu(_gn(p["gn1"], _conv(p["conv1"], x), ng))
    out = F.relu(_gn(p["gn2"], _conv(p["conv2"], out, stride), ng))
    out = _gn(p["gn3"], _conv(p["conv3"], out), ng)
    if "down_conv" in p:
        x = _gn(p["down_gn"], _conv(p["down_conv"], x, stride), ng)
    return F.relu(out + x)


def encode_depth(params: Params, cfg: DepthEncoderConfig, depth: torch.Tensor) -> torch.Tensor:
    """``[B, S, S, 1]`` metric depth / 10 -> ``[B, 32 * (S / 32)^2]``."""
    ng = cfg.ngroups
    x = depth.permute(0, 3, 1, 2)
    x = F.relu(_gn(params["stem_gn"], _conv(params["stem_conv"], x, stride=2), ng))
    x = _maxpool_same(x)
    for si, blocks in enumerate(_STAGES):
        for bi in range(blocks):
            x = _bottleneck(params["stages"][si][bi], x, 2 if (bi == 0 and si > 0) else 1, ng)
    x = F.relu(_gn(params["compress_gn"], _conv(params["compress_conv"], x), 1))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def feature_dim(cfg: DepthEncoderConfig) -> int:
    """Length of ``encode_depth``'s output row: the stem, the pool and
    three stride-2 stages each halve the side, rounding up."""
    side = cfg.input_size
    for _ in range(5):
        side = math.ceil(side / 2)
    return 32 * side * side


def init_depth_params(gen: torch.Generator, cfg: DepthEncoderConfig,
                      device: DeviceLike = None) -> Params:
    """He-normal convolutions, unit GroupNorm, on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)

    def conv(kh, cin, cout):
        w = torch.randn(cout, cin, kh, kh, generator=gen, device=device)
        return {"w": w * (2.0 / (kh * kh * cin)) ** 0.5}

    def gn(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}

    bp = cfg.base_planes
    params: Params = {"stem_conv": conv(7, 1, bp), "stem_gn": gn(bp), "stages": []}
    inplanes = bp
    for si, blocks in enumerate(_STAGES):
        planes = bp * (2 ** si)
        stage = []
        for bi in range(blocks):
            blk = {"conv1": conv(1, inplanes, planes), "gn1": gn(planes),
                   "conv2": conv(3, planes, planes), "gn2": gn(planes),
                   "conv3": conv(1, planes, planes * 4), "gn3": gn(planes * 4)}
            if bi == 0:
                blk["down_conv"] = conv(1, inplanes, planes * 4)
                blk["down_gn"] = gn(planes * 4)
                inplanes = planes * 4
            stage.append(blk)
        params["stages"].append(stage)
    params["compress_conv"] = conv(3, inplanes, 32)
    params["compress_gn"] = gn(32)
    return params
