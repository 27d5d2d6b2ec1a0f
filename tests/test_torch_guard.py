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


def test_decode_route_kernel_wrappers_refuse_cpu_tensors():
    from dynam3d_torch.ops.decode import decode_attn_layer_cuda
    from dynam3d_torch.ops.int4 import (
        int4_matvec2d_cuda, int4_mlp_block_cuda, int4_mlp_cuda, pack_int4,
    )

    D, I = 64, 128
    gu = pack_int4(torch.randn(D, 2 * I), dblk=64, nblk=32)
    dn = pack_int4(torch.randn(I, D), dblk=64, nblk=32)
    x = torch.randn(2, D)
    with pytest.raises(ValueError, match="CUDA"):
        int4_matvec2d_cuda(x, gu)
    with pytest.raises(ValueError, match="CUDA"):
        int4_mlp_cuda(x, gu, dn)
    with pytest.raises(ValueError, match="CUDA"):
        int4_mlp_block_cuda(x, torch.ones(D), gu, dn, 1e-5)
    qkv = pack_int4(torch.randn(D, 3 * D), dblk=64, nblk=32)
    o = pack_int4(torch.randn(D, D), dblk=64, nblk=32)
    cache = torch.zeros(1, 1, 512, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_layer_cuda(x[:1].view(1, 1, D).to(torch.bfloat16), torch.ones(D), qkv, o,
                               cache, cache, 0, 40, torch.ones(512, dtype=torch.bool),
                               torch.ones(16), torch.zeros(16), eps=1e-5, heads=2, hd=32)


def test_decode_gates_are_read_at_call_time(monkeypatch):
    from dynam3d_torch import flags

    gates = {"DYNAM3D_SPEC_DECODE": (flags.spec_decode, True),
             "DYNAM3D_FUSED_ATTN": (flags.fused_attn, True),
             "DYNAM3D_FUSED_RING": (flags.fused_ring, True),
             "DYNAM3D_INT4_FUSED_MLP": (flags.int4_fused_mlp, True),
             "DYNAM3D_INT4_GRID2D": (flags.int4_grid2d, False)}
    for name, (gate, default) in gates.items():
        monkeypatch.delenv(name, raising=False)
        assert gate() is default, name
        monkeypatch.setenv(name, "0" if default else "1")
        assert gate() is (not default), name


def test_launch_counters_lose_no_update_across_threads():
    """``run_interleaved`` launches from threads: concurrent counts add up."""
    import os
    import sys
    import threading

    from dynam3d_torch.ops import kernels

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_counts()
        n_threads, per = 2 * (os.cpu_count() or 2), 2000

        def work():
            for _ in range(per):
                kernels.count(kernels.launches, "int4_mlp")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.launches["int4_mlp"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        kernels.reset_counts()


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
