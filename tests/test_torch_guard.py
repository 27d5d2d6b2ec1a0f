"""Boundaries of the PyTorch port: it imports neither JAX nor the reference
package (nor does chip_smoke.py), its entry points never fall back to the
CPU on their own, and a kernel wrapper refuses tensors that are not on the
card."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dynam3d_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "dynam3d_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        dynam3d_torch.__path__, prefix="dynam3d_torch."))


def test_port_imports_no_jax_in_a_fresh_process():
    mods = _all_modules()
    for m in ("models.policy", "ops.decode", "ops.knn", "ops.nerf_mlp", "models.render.nerf",
              "models.memory3d.pretrain", "runtime.losses_3dff", "runtime.trainer_3dff",
              "runtime.pretrain_loop"):
        assert f"dynam3d_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["chip_smoke.py", "dynam3d_torch"])
def test_sources_import_no_jax(path):
    p = ROOT / path
    files = [p] if p.is_file() else sorted(p.rglob("*.py"))
    assert files
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & set(FORBIDDEN), (f, roots & set(FORBIDDEN))


def test_entry_points_raise_without_a_device(monkeypatch):
    from dynam3d_torch.config import Dynam3DConfig, SegmenterConfig
    from dynam3d_torch.models.policy import init_policy_params
    from dynam3d_torch.runtime.episode import EpisodeRunner

    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Dynam3DConfig(segmenter=SegmenterConfig(provider="depth_plane"))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_policy_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EpisodeRunner({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PretrainRunner({}, cfg, device=None)


def test_kernel_wrappers_refuse_cpu_tensors():
    from dynam3d_torch.ops.decode import decode_attn_cuda
    from dynam3d_torch.ops.int4 import int4_matvec_cuda, pack_int4

    w = pack_int4(torch.randn(64, 64), dblk=64, nblk=32)
    with pytest.raises(ValueError, match="CUDA"):
        int4_matvec_cuda(torch.randn(1, 64), w)
    qkv = torch.randn(1, 3 * 64)
    cache = torch.zeros(1, 1, 512, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_cuda(qkv, torch.ones(16), torch.zeros(16), cache, cache, 0,
                         torch.ones(512, dtype=torch.bool), 512, 1, heads=2, hd=32)


def test_pretrain_kernel_wrappers_refuse_cpu_tensors():
    from dynam3d_torch.ops.knn import knn_topk_cuda
    from dynam3d_torch.ops.nerf_mlp import nerf_mlp_cuda

    with pytest.raises(ValueError, match="CUDA"):
        knn_topk_cuda(torch.zeros(4, 3), torch.zeros(8, 3), torch.ones(8, dtype=torch.bool), 2)
    w = [torch.zeros(128, 128)] * 2 + [torch.zeros(128, 129)] + [torch.zeros(128, 128)] * 3
    with pytest.raises(ValueError, match="CUDA"):
        nerf_mlp_cuda(torch.zeros(4, 128), *w)


def test_yolov8_provider_is_refused_not_replaced():
    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models.policy import init_policy_params

    with pytest.raises(NotImplementedError, match="depth_plane"):
        init_policy_params(0, Dynam3DConfig(), device="cpu")
