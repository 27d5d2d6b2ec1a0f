"""Random weights of the 3DFF pretraining configuration from ``--seed``:
the frozen CLIP image tower and the memory's modules as ``weights.py``
makes them, and the renderer (``render``) as its initialiser describes it:
normal weights of std ``fts_dim ** -0.5``, zero biases, unit LayerNorms,
``mlp_net_layers`` hidden layers split between the NeRF MLP's encoder and
decoder.  One generator serves the whole tree, in the order clip, fields,
render, so the same seed gives the same tree on both sides of the check.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench import weights


def render(g, dev, f) -> Dict[str, Any]:
    D, K = f.fts_dim, f.search_num
    n_enc = f.mlp_net_layers // 2
    std = D ** -0.5

    def w(i, o):
        return weights._randn(g, dev, i, o) * std

    return {"pos_w": w(6, D), "pos_b": torch.zeros(D, device=dev), "pos_ln": weights._ln(dev, D),
            "agg_w": w(K * D, D), "agg_b": torch.zeros(D, device=dev),
            "agg_ln": weights._ln(dev, D),
            "mlp": {"enc_hidden": [w(D, D) for _ in range(n_enc)], "enc_out": w(D, D + 1),
                    "dec_hidden": [w(D, D) for _ in range(f.mlp_net_layers - n_enc)],
                    "dec_out": w(D, D)}}


def _tree(g, cfg, dev) -> Dict[str, Any]:
    return {"clip": weights.clip_tower(g, dev, cfg.clip),
            "fields": weights.fields(g, dev, cfg.fields),
            "render": render(g, dev, cfg.fields)}


def fields_params(seed: int, ref_cfg, device: torch.device) -> Dict[str, Any]:
    """``{"clip", "fields", "render"}`` for the configuration ``ref_cfg``
    (``reference/fields_ref.config``)."""
    return weights.make_tree(_tree, seed, device, ref_cfg, device)
