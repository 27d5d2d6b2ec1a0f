"""Neural feature-field rendering of novel-view patch features.

Port of ``models/render/nerf.py``: ``nerf_mlp`` (kernel C on the card, with
the autograd of the reference's chain as its gradient), ``raw2feature``,
``render_view`` (habitat camera), ``render_panorama`` (four of them),
``render_view_posed`` (pinhole K and camera-to-world ``(R, T)``), their
shared ``_render_core`` and ``init_render_params``.

Per view: ``view_height x view_width`` rays of ``n_samples`` points; stage 1
scores every sample by the summed distance of its ``search_num`` nearest
patches (clamped at ``search_radius``) and keeps the ``n_importance`` best
per ray; stage 2 conditions each kept sample on its neighbours' features
and relative geometry, runs the NeRF MLP and alpha-composites over the full
sample grid.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from dynam3d_torch import flags
from dynam3d_torch.config import FieldsConfig
from dynam3d_torch.geom.projection import (
    camera_heading_from_rotation, ray_grid_habitat, ray_grid_intrinsics,
)
from dynam3d_torch.models.memory3d.state import FieldState
from dynam3d_torch.ops.knn import (
    knn_auto, knn_banded, knn_brute, morton_perm, radius_mask_fill,
)
from dynam3d_torch.ops.nerf_mlp import fused_nerf_mlp, leaky_relu
from dynam3d_torch.ops.transformer import dot_f32, layer_norm

Params = Dict[str, Any]


def _nerf_mlp_chain(x: torch.Tensor, enc_hidden: List[torch.Tensor], eo_w: torch.Tensor,
                    dec_hidden: List[torch.Tensor], do_w: torch.Tensor):
    """The reference's chain over raw weights, any depth: bf16 activations
    times the float32 weights (type promotion: float32 products of the
    bf16-rounded activations); a hidden layer rounds its sums to bf16 and
    applies LeakyReLU in bf16, the encoder output applies it in float32.
    (Kernel C applies every LeakyReLU in float32 before rounding, and
    rounds the weights: the two differ by a bf16 step here and there.)"""
    h = x.to(torch.bfloat16)
    for w in enc_hidden:
        h = leaky_relu(dot_f32(h, w).to(torch.bfloat16))
    eo = leaky_relu(dot_f32(h, eo_w))
    enc, density = eo[..., :-1], eo[..., -1]
    h = (enc + x.to(torch.float32)).to(torch.bfloat16)
    for w in dec_hidden:
        h = leaky_relu(dot_f32(h, w).to(torch.bfloat16))
    out = dot_f32(h, do_w)
    return out.to(torch.bfloat16), density.to(torch.bfloat16)


class _KernelNerfMLP(torch.autograd.Function):
    """Forward: kernel C.  Backward: autograd of :func:`_nerf_mlp_chain`
    recomputed from the saved inputs (the reference's custom VJP; there is
    no backward kernel)."""

    @staticmethod
    def forward(ctx, x, e1, e2, eo, d1, d2, do):
        ctx.save_for_backward(x, e1, e2, eo, d1, d2, do)
        return fused_nerf_mlp(x, e1, e2, eo, d1, d2, do)

    @staticmethod
    def backward(ctx, g_out, g_dens):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            x, e1, e2, eo, d1, d2, do = saved
            out, dens = _nerf_mlp_chain(x, [e1, e2], eo, [d1, d2], do)
            grads = torch.autograd.grad((out, dens), saved, (g_out, g_dens),
                                        allow_unused=True)
        return tuple(grads)


def nerf_mlp(p: Params, x: torch.Tensor, cfg: FieldsConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder (+density) -> residual -> decoder: ``(features [N, D] bf16,
    density [N] bf16)``.  On the card with 2 + 2 hidden layers this is
    kernel C; elsewhere the chain."""
    if x.is_cuda and len(p["enc_hidden"]) == 2 and len(p["dec_hidden"]) == 2:
        return _KernelNerfMLP.apply(x, p["enc_hidden"][0], p["enc_hidden"][1], p["enc_out"],
                                    p["dec_hidden"][0], p["dec_hidden"][1], p["dec_out"])
    return _nerf_mlp_chain(x, p["enc_hidden"], p["enc_out"], p["dec_hidden"], p["dec_out"])


def raw2feature(sample_feature: torch.Tensor, sample_density: torch.Tensor,
                rel_dist: torch.Tensor, topk_inds: torch.Tensor):
    """Volume compositing: softplus densities scattered to the kept samples
    of the full ``[R, NS]`` grid, alpha compositing, L2-normalized feature
    map ``[R, D]`` and depth ``[R]``."""
    density_sp = torch.logaddexp(sample_density.to(torch.float32),
                                 torch.zeros((), device=sample_density.device))
    dists = torch.abs(rel_dist[..., 1:] - rel_dist[..., :-1])
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    density = torch.zeros(rel_dist.shape, dtype=torch.float32,
                          device=rel_dist.device).scatter(1, topk_inds, density_sp)
    alpha = 1.0 - torch.exp(-torch.relu(density) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                          dim=-1)[..., :-1]
    weights = alpha * trans
    sample_w = torch.gather(weights, 1, topk_inds)
    fmap = (sample_w[..., None] * sample_feature.to(torch.float32)).sum(dim=-2)
    fmap = fmap / torch.clamp(torch.linalg.norm(fmap, dim=-1, keepdim=True), min=1e-7)
    depth = (weights * rel_dist).sum(-1) / torch.clamp(weights.sum(-1), min=1e-7)
    return fmap, depth


class RenderOut(NamedTuple):
    features: torch.Tensor    # [H, W, D] rendered patch features
    positions: torch.Tensor   # [H, W, 3] first kept sample per ray
    depth: torch.Tensor       # [H, W]


def render_view(params: Params, cfg: FieldsConfig, state: FieldState,
                camera_position: torch.Tensor, camera_heading: torch.Tensor) -> RenderOut:
    """One novel view from a world ``camera_position [3]`` and heading."""
    dev = state.patch_pos.device
    (rel_x, rel_y, rel_z), rel_dir, rel_dist = ray_grid_habitat(
        height=cfg.view_height, width=cfg.view_width, hfov_deg=cfg.view_hfov,
        vfov_deg=cfg.view_vfov, near=cfg.near, far=cfg.far, n_samples=cfg.n_samples)
    rel_x, rel_y, rel_z, rel_dir, rel_dist = (
        torch.as_tensor(a, device=dev) for a in (rel_x, rel_y, rel_z, rel_dir, rel_dist))
    heading = torch.as_tensor(camera_heading, dtype=torch.float32, device=dev)
    ch, sh = torch.cos(heading), torch.sin(heading)
    ray_x = rel_x * ch - rel_y * sh + camera_position[0]
    ray_y = rel_x * sh + rel_y * ch + camera_position[1]
    ray_z = rel_z + camera_position[2]
    ray_xyz = torch.stack([ray_x, ray_y, ray_z], dim=-1)          # [R, NS, 3]
    return _render_core(params, cfg, state, ray_xyz, rel_dir, rel_dist, heading)


def render_view_posed(params: Params, cfg: FieldsConfig, state: FieldState,
                      intrinsics: torch.Tensor, rot: torch.Tensor,
                      trans: torch.Tensor) -> RenderOut:
    """One novel view from a view-resolution K and camera-to-world
    ``(rot, trans)``: pitch and true field of view are kept; the camera
    direction is the reference's T-polluted heading."""
    rel_position, rel_dir, rel_dist = ray_grid_intrinsics(
        intrinsics, height=cfg.view_height, width=cfg.view_width, near=cfg.near,
        far=cfg.far, n_samples=cfg.n_samples)
    ray_xyz = rel_position @ rot.T + trans[None, None, :]
    heading, _ = camera_heading_from_rotation(rot, trans)
    return _render_core(params, cfg, state, ray_xyz, rel_dir, rel_dist, heading)


def render_panorama(params: Params, cfg: FieldsConfig, state: FieldState,
                    position: torch.Tensor, heading) -> Tuple[torch.Tensor, torch.Tensor]:
    """Four 90-degree views clockwise from behind the agent (view ``i`` at
    ``(heading - i pi / 2 + 3 pi / 4) mod 2 pi``): features ``[H, 4W, D]``
    and positions ``[H, 4W, 3]``, the views side by side."""
    fts, pos = [], []
    for view_id in range(4):
        h = (heading + view_id * (-math.pi / 2.0) + math.pi * 3.0 / 4.0) % (2.0 * math.pi)
        out = render_view(params, cfg, state, position, h)
        fts.append(out.features)
        pos.append(out.positions)
    return torch.cat(fts, dim=1), torch.cat(pos, dim=1)


def _stage1_sq_dists(cfg: FieldsConfig, state: FieldState, ray_xyz: torch.Tensor) -> torch.Tensor:
    """Squared distances of every ray sample to its ``search_num`` nearest
    patches, exact within ``search_radius`` (only the distances are read)."""
    K = cfg.search_num
    if flags.disable_banded_knn():
        return knn_auto(ray_xyz.reshape(-1, 3), state.patch_pos, state.patch_valid, K)[0]
    ppos, pval = state.patch_pos, state.patch_valid
    if not flags.disable_morton_knn():
        perm = morton_perm(ppos, pval)
        ppos, pval = ppos[perm], pval[perm]
    return knn_banded(ray_xyz, ppos, pval, K, cfg.search_radius, tile=cfg.knn_tile,
                      band=cfg.knn_band, with_indices=False)[0]


def _render_core(params: Params, cfg: FieldsConfig, state: FieldState, ray_xyz: torch.Tensor,
                 rel_dir: torch.Tensor, rel_dist: torch.Tensor,
                 camera_heading: torch.Tensor) -> RenderOut:
    """Importance sampling, neighbour conditioning, NeRF MLP, compositing."""
    H, W = cfg.view_height, cfg.view_width
    NS, NI, K, D = cfg.n_samples, cfg.n_importance, cfg.search_num, cfg.fts_dim
    R = H * W
    ray_xyz = ray_xyz.detach()

    # stage 1: density proxy from the k-NN distances of every sample
    with torch.no_grad():
        sq_d = _stage1_sq_dists(cfg, state, ray_xyz)
        d1, _ = radius_mask_fill(sq_d, torch.zeros_like(sq_d, dtype=torch.int64),
                                 cfg.search_radius, clamp_dist=True)
        tmp_density = 1.0 / torch.clamp(d1.sum(-1).reshape(R, NS), min=1e-9)
        # ties (every neighbour beyond the radius) go to the lower index
        topk_inds = torch.sort(tmp_density, dim=1, descending=True, stable=True).indices[:, :NI]
    sample_xyz = torch.gather(ray_xyz, 1, topk_inds[..., None].expand(R, NI, 3))

    # stage 2: neighbours of the kept samples
    sq2, ind2 = knn_brute(sample_xyz.reshape(-1, 3), state.patch_pos, state.patch_valid, K)
    _, ind2 = radius_mask_fill(sq2, ind2, cfg.search_radius)
    ind2 = ind2.reshape(R, NI, K)
    live = ind2 >= 0
    idx = torch.clamp(ind2, min=0)

    rel = state.patch_pos[idx] - sample_xyz[..., None, :]
    cmh, smh = torch.cos(-camera_heading), torch.sin(-camera_heading)
    rx = rel[..., 0] * cmh - rel[..., 1] * smh
    ry = rel[..., 0] * smh + rel[..., 1] * cmh
    rel = torch.stack([rx, ry, rel[..., 2]], dim=-1)
    rel = torch.where(live[..., None], rel, torch.full_like(rel, cfg.far))

    ddir = (state.patch_dir[idx] - camera_heading) - rel_dir[:, 0][:, None, None]
    dir_sc = torch.stack([torch.sin(ddir), torch.cos(ddir)], dim=-1)
    dir_sc = torch.where(live[..., None], dir_sc, torch.zeros_like(dir_sc))
    nb_scale = torch.where(live, state.patch_scale[idx], torch.zeros_like(rel[..., 0]))[..., None]
    xyzds = torch.cat([rel, dir_sc, nb_scale], dim=-1)             # [R, NI, K, 6]
    nb_fts = torch.where(live[..., None], state.patch_fts[idx].to(torch.float32),
                         torch.zeros((), device=idx.device))

    pe = xyzds @ params["pos_w"] + params["pos_b"]
    pe = layer_norm(params["pos_ln"], pe, eps=1e-12)
    fused = nb_fts.reshape(R * NI, K * D) + pe.reshape(R * NI, K * D)
    agg = fused @ params["agg_w"] + params["agg_b"]
    agg = layer_norm(params["agg_ln"], agg, eps=1e-12)

    feat, dens = nerf_mlp(params["mlp"], agg, cfg)
    fmap, depth = raw2feature(feat.reshape(R, NI, D), dens.reshape(R, NI), rel_dist, topk_inds)
    return RenderOut(fmap.reshape(H, W, D), sample_xyz[:, 0].reshape(H, W, 3),
                     depth.reshape(H, W))


def init_render_params(gen: torch.Generator, cfg: FieldsConfig, device) -> Params:
    """Random renderer parameters: std ``D ** -0.5`` normal weights, zero
    biases, unit LayerNorms; ``mlp_net_layers`` hidden layers split between
    encoder and decoder."""
    D, K = cfg.fts_dim, cfg.search_num
    n_enc = cfg.mlp_net_layers // 2
    n_dec = cfg.mlp_net_layers - n_enc
    std = D ** -0.5

    def w(i, o):
        return std * torch.randn(i, o, generator=gen, device=device)

    def ln():
        return {"scale": torch.ones(D, device=device), "bias": torch.zeros(D, device=device)}

    return {
        "pos_w": w(6, D), "pos_b": torch.zeros(D, device=device), "pos_ln": ln(),
        "agg_w": w(K * D, D), "agg_b": torch.zeros(D, device=device), "agg_ln": ln(),
        "mlp": {
            "enc_hidden": [w(D, D) for _ in range(n_enc)],
            "enc_out": w(D, D + 1),
            "dec_hidden": [w(D, D) for _ in range(n_dec)],
            "dec_out": w(D, D),
        },
    }
