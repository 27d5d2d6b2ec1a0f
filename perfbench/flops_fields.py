"""The 3DFF pretraining cell's arithmetic from shapes: kernel C's
operations and bytes, the renderer's model FLOPs, and a step's model FLOPs
(``flops.py`` holds the peaks)."""

from __future__ import annotations

from typing import Dict

import torch

from perfbench import flops


def nerf_mlp_flops(n: int, D: int) -> float:
    """Kernel C over ``n`` rows: two D x D encoder layers, the D x (D + 1)
    encoder output (the density its last column), two D x D decoder
    layers and the D x D output."""
    return 2.0 * n * (6 * D * D + D)


def nerf_mlp_bytes(n: int, D: int) -> float:
    """What kernel C moves: the float32 rows in, its bf16 weights (six D x D
    blocks and the density column), the bf16 features and densities out."""
    return 4.0 * n * D + 2.0 * (6 * D * D + D) + 2.0 * n * D + 2.0 * n


def nerf_mlp_bound_s(n: int, D: int) -> float:
    """The larger of kernel C's two bounds: its operations at the bf16 peak
    and its bytes at the HBM rate."""
    return max(nerf_mlp_flops(n, D) / flops.BF16_PEAK, nerf_mlp_bytes(n, D) / flops.HBM_BPS)


def render_rows(f) -> int:
    """Rows of one novel view through the NeRF MLP: its rays times the
    importance samples kept on each."""
    return f.view_height * f.view_width * f.n_importance


def render_train_flops(f, views: int = 2) -> float:
    """Model FLOPs of rendering ``views`` novel views, forward and backward
    (twice the forward): per kept sample, the position layer over its
    ``search_num`` neighbours, the aggregation layer and the NeRF MLP (the
    k-NN searches are no model FLOPs)."""
    n, D, K = render_rows(f), f.fts_dim, f.search_num
    fwd = 2.0 * n * K * 6 * D + 2.0 * n * K * D * D + nerf_mlp_flops(n, D)
    return 3.0 * views * fwd


def step_flops(seed: int, rcfg, scene: Dict, dev) -> float:
    """Model FLOPs of one pretraining step on ``scene``, recompute left
    out: the frozen CLIP encode of the frames (forward), the fold's
    encoders forward and backward (three times the forward that
    ``flop_counter`` counts over the plain reference's fold, seed weights),
    and :func:`render_train_flops`."""
    from perfbench import weights_fields
    from perfbench.reference import fields_ref as ref

    params = weights_fields.fields_params(seed, rcfg, dev)
    f = rcfg.fields
    with torch.no_grad():
        b = ref.build(params, rcfg, scene, dev)
    clip = flops.counted_flops(ref.clip_features, params["clip"], rcfg.clip,
                               torch.as_tensor(scene["rgb"], device=dev))
    gt = {"xyz": torch.as_tensor(scene["gt_xyz"], device=dev).float(),
          "label": torch.as_tensor(scene["gt_label"], device=dev).long(), "max_label": 512}
    gt["valid"] = torch.ones(gt["xyz"].shape[0], dtype=torch.bool, device=dev)
    prec = ref.Precision(rcfg)

    def fold():
        t = ref.empty_table(f, dev)
        for v in range(b["grid"].shape[0]):
            t, _, _ = ref.fold_view(params["fields"], t, f, prec,
                                    {"depth": b["depth"][v], "grid": b["grid"][v],
                                     "segm": b["segm"][v], "cam": b["cams"][v],
                                     "heading": b["headings"][v]}, gt)

    total = clip + 3.0 * flops.counted_flops(fold) + render_train_flops(f, len(b["novel"]))
    del params
    return total
