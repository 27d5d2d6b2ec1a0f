"""Learned modules of the 3D memory; port of ``models/memory3d/params.py``."""

from __future__ import annotations

from typing import Any, Dict

import torch

from dynam3d_torch.config import FieldsConfig
from dynam3d_torch.ops.transformer import (
    init_dense, init_encoder_stack, init_ln, init_mlp2,
)


def init_field_params(gen: torch.Generator, cfg: FieldsConfig, device) -> Dict[str, Any]:
    d = cfg.fts_dim
    scale = d ** -0.5
    return {
        "patch_pos_mlp": init_mlp2(gen, 7, d, d, device),
        "p2i_agg_token": scale * torch.randn(1, d, generator=gen, device=device),
        "p2i_encoder": init_encoder_stack(gen, d, 4 * d, 2, device),
        "inst_pos_mlp": init_mlp2(gen, 4, d, d, device),
        "i2z_agg_token": scale * torch.randn(1, d, generator=gen, device=device),
        "i2z_encoder": init_encoder_stack(gen, d, 4 * d, 2, device),
        "merge_disc": {
            "fc1": init_dense(gen, 2 * d + 3, 4 * d, device),
            "ln": init_ln(4 * d, device),
            "fc2": init_dense(gen, 4 * d, 2, device),
        },
    }
