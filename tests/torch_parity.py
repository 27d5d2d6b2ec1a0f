"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through the JAX function and
its port; parameters are made once by the JAX package and converted with
``dynam3d_torch.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import torch

# Under pytest-xdist every worker collects every module; torch would give
# each of them all of the host's cores as intra-op threads, and N workers
# oversubscribe the host N times.  Share the cores out instead.
_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))

from dynam3d_torch import config as tcfg
from dynam3d_torch.convert import params_from_jax


def port_config(jcfg) -> tcfg.Dynam3DConfig:
    """The port's config with the same values as a reference config (the
    two trees have the same sections and fields)."""
    return tcfg.from_dict(dataclasses.asdict(jcfg))


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


def walk_config():
    """The reference walk tests' tiny config (``tests/test_pretrain_loop.py``):
    ``test_torch_pretrain_loop.CFG`` (float32 encoders and CLIP) with the
    depth encoder at ``input_size`` 64 and the default waypoint predictor."""
    from dynam3d_tpu.config import DepthEncoderConfig
    from tests.test_torch_pretrain_loop import CFG

    return dataclasses.replace(CFG, depth=DepthEncoderConfig(input_size=64))


def walk_params(jcfg, seed: int):
    """Reference parameters of the walk: the trained ``fields`` and
    ``render``, the frozen ``clip``, ``depth_enc`` and ``waypoint``."""
    from dynam3d_tpu.models.encoders.clip import init_clip_params
    from dynam3d_tpu.models.encoders.depth_resnet import init_depth_params
    from dynam3d_tpu.models.memory3d import init_field_params
    from dynam3d_tpu.models.render.nerf import init_render_params
    from dynam3d_tpu.models.waypoint.trm import init_waypoint_params
    from dynam3d_torch.models.encoders.depth_resnet import feature_dim

    def init(key):
        return {
            "fields": init_field_params(key, jcfg.fields),
            "render": init_render_params(jax.random.fold_in(key, 1), jcfg.fields),
            "clip": init_clip_params(jax.random.fold_in(key, 2), jcfg.clip),
            "depth_enc": init_depth_params(jax.random.fold_in(key, 3), jcfg.depth),
            "waypoint": init_waypoint_params(jax.random.fold_in(key, 4), jcfg.waypoint,
                                             depth_feat_dim=feature_dim(jcfg.depth)),
        }

    # one program: the eager initialisers dispatch thousands of small ops
    return jax.jit(init)(jax.random.PRNGKey(seed))


def assert_trained_close(tparams, jparams, fts_dim: int, noise: float) -> None:
    """``fields`` and ``render`` trained by both packages: within 1e-5,
    save where Adam's normalized step turns float noise into a move of up
    to the learning rate per update (``noise`` in all, either way): the key
    third of each attention ``qkv`` bias, whose gradient is zero in exact
    arithmetic, and in ``render`` (behind the NeRF MLP's bf16 backward) at
    most 0.5% of a leaf's entries."""
    from dynam3d_torch.utils.tree import tree_leaves
    from tests.test_torch_pretrain import _jax_paths, _paths

    for part in ("fields", "render"):
        want = _jax_paths(jparams[part])
        for name, a in zip(_paths(tparams[part]), tree_leaves(tparams[part])):
            got, ref = np32(a), np32(want[name])
            err = np.abs(got - ref)
            tol = np.full(ref.shape, 1e-5, np.float32)
            if name.endswith("attn/qkv/b"):
                tol[fts_dim:2 * fts_dim] = noise
            label = f"{part}{name}"
            if part == "render":
                assert (err > tol).mean() <= 5e-3 and (err <= noise).all(), (label, err.max())
            else:
                assert (err <= tol).all(), (label, err.max())


def reference_layout(tree, conv: bool = False):
    """Port parameters -> the reference's layout, the inverse of
    ``params_from_jax`` for dense trees: numpy leaves, HWIO convolutions
    under ``yolo`` / ``depth_enc`` (or everywhere with ``conv``), bf16 as
    ``jnp.bfloat16`` arrays."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: reference_layout(v, conv or k in ("yolo", "depth_enc")) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reference_layout(v, conv) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    a = t.numpy().copy()
    return a.transpose(2, 3, 1, 0).copy() if conv and a.ndim == 4 else a


def assert_trees_identical(got, want, path: str = "") -> None:
    """Two port trees with the same structure, dtypes and values, bit for
    bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got))
        for k in want:
            assert_trees_identical(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_identical(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype,
                                                                     got.shape, want.shape)
        assert torch.equal(got.cpu(), want.cpu()), (path, (got.float() - want.float()).abs().max())


def runway_world():
    """The reference-weights runway's tiny world: both packages' configs
    (the parity tool's ``tiny``, renderer width = ``fts_dim``), the port's
    policy, renderer, waypoint (2 layers of 64) and depth-encoder trees
    from seeds, their reference layouts, and the reference's ``synth_all``
    of those (numpy state dicts)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from parity_run import _config as jax_config

    from dynam3d_tpu.config import apply_opts
    from dynam3d_tpu.runtime import synth_sd as jsynth
    from dynam3d_torch.config import DepthEncoderConfig, WaypointConfig
    from dynam3d_torch.models import policy as tpolicy
    from dynam3d_torch.models.encoders.depth_resnet import init_depth_params
    from dynam3d_torch.models.render import nerf as tnerf
    from dynam3d_torch.models.waypoint.trm import init_waypoint_params

    jcfg = jax_config("tiny", 2)
    jcfg = apply_opts(jcfg, [f"fields.mlp_net_width={jcfg.fields.fts_dim}"])
    tcfg = port_config(jcfg)
    trees = {
        "params": tpolicy.init_policy_params(0, tcfg, device="cpu"),
        "render": tnerf.init_render_params(torch.Generator().manual_seed(1), tcfg.fields, "cpu"),
        "waypoint": init_waypoint_params(torch.Generator().manual_seed(2),
                                         WaypointConfig(hidden_dim=64, num_attention_heads=4),
                                         96, device="cpu"),
        "depth_enc": init_depth_params(torch.Generator().manual_seed(3),
                                       DepthEncoderConfig(input_size=32, base_planes=8,
                                                          ngroups=4), device="cpu"),
    }
    ref = {k: reference_layout(v, conv=k == "depth_enc") for k, v in trees.items()}
    sds = jsynth.synth_all(ref["params"], jcfg, render_params=ref["render"],
                           waypoint_params=ref["waypoint"], depth_params=ref["depth_enc"])
    return jcfg, tcfg, trees, ref, sds
