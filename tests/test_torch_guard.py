"""Boundaries of the PyTorch port: it imports neither JAX nor the reference
package (nor does chip_smoke.py), its entry points never fall back to the
CPU on their own, and a kernel wrapper refuses tensors that are not on the
card."""

import ast
import os
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
              "runtime.pretrain_loop", "models.encoders.yolov8_seg", "ops.int4_stream",
              "tools.bench_int4_stream", "tools.bench_int4_unpack", "runtime.vln_loop",
              "runtime.trainer_vln", "runtime.checkpoint", "runtime.metrics", "ops.nms",
              "models.waypoint.trm", "models.encoders.depth_resnet", "models.policy_3dff",
              "runtime.logging", "models.encoders.clip_tokenizer", "models.encoders.clip",
              "geom.projection", "run", "runtime.feed", "runtime.vector_feed",
              "runtime.profiling", "tools.record_episodes", "tools.make_golden_fixtures",
              "tools.eval_soak"):
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


@pytest.mark.parametrize("entry", ["VLNTrainer", "evaluate", "inference"])
def test_vln_entry_points_raise_without_a_device(entry, monkeypatch):
    """The trainer, ``evaluate`` and ``inference`` take ``device=None`` as
    the card and raise without one, before any work."""
    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.runtime import vln_loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Dynam3DConfig()
    calls = {
        "VLNTrainer": lambda: vln_loop.VLNTrainer({}, cfg, lambda: None),
        "evaluate": lambda: vln_loop.evaluate({}, cfg, [], []),
        "inference": lambda: vln_loop.inference({}, cfg, [], []),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["run", "eval_soak"])
def test_cli_entry_points_raise_without_a_device(entry, tmp_path, monkeypatch):
    """``run.main`` and ``tools.eval_soak.main`` take ``device=None`` as
    the card: without one they raise before writing anything."""
    from dynam3d_torch import run
    from dynam3d_torch.tools import eval_soak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = {
        "run": lambda: run.main(["--run-type", "eval", "--exp_name", "x"]),
        "eval_soak": lambda: eval_soak.main(["--out", str(tmp_path / "soak"), "--scale", "tiny"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("entry", ["init_cache", "init_phi3_params", "init_llava_params",
                                   "init_depth_params", "init_waypoint_params"])
def test_model_initialisers_resolve_none_to_the_card(entry, monkeypatch):
    """The Phi-3 and LLaVA initialisers take ``device=None`` as the card, as
    every other entry point does: without one they raise, and with
    ``device="cpu"`` they build on the CPU."""
    from dynam3d_torch.config import (
        CLIPConfig, DepthEncoderConfig, LLaVAConfig, Phi3Config, WaypointConfig,
    )
    from dynam3d_torch.models.encoders import depth_resnet
    from dynam3d_torch.models.vlm import llava, phi3
    from dynam3d_torch.models.waypoint import trm

    pcfg = Phi3Config(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                      num_heads=2, num_kv_heads=2, head_dim=16, pad_token_id=60,
                      end_token_id=61)
    ccfg = CLIPConfig(image_size=28, patch_size=14, vision_width=32, vision_layers=1,
                      vision_heads=2, embed_dim=32)
    lcfg = LLaVAConfig(phi3=pcfg, projector_hidden=32)
    calls = {
        "init_cache": lambda **kw: phi3.init_cache(pcfg, 1, 8, **kw),
        "init_phi3_params": lambda **kw: phi3.init_phi3_params(torch.Generator(), pcfg, **kw),
        "init_llava_params": lambda **kw: llava.init_llava_params(torch.Generator(), lcfg, ccfg,
                                                                  **kw),
        "init_depth_params": lambda **kw: depth_resnet.init_depth_params(
            torch.Generator(), DepthEncoderConfig(input_size=32, base_planes=8, ngroups=4), **kw),
        "init_waypoint_params": lambda **kw: trm.init_waypoint_params(
            torch.Generator(), WaypointConfig(hidden_dim=32, trm_layers=1,
                                              num_attention_heads=4), 64, **kw),
    }
    made = calls[entry](device="cpu")
    if entry == "init_cache":
        leaves = list(made)
    elif entry == "init_depth_params":
        leaves = [made["stem_conv"]["w"], made["compress_gn"]["scale"]]
    elif entry == "init_waypoint_params":
        leaves = [made["visual_fc_depth"]["w"], made["bert_layers"][0]["ln1"]["scale"]]
    else:
        leaves = [made.get("phi3", made)["final_ln"]]
    assert all(t.device.type == "cpu" for t in leaves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


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


def test_yolov8_provider_is_refused_not_replaced(monkeypatch):
    """The default provider is neither refused nor replaced: the YOLOv8-seg
    parameters are built and ``perceive`` segments with them, never with
    the depth_plane provider."""
    import dataclasses

    from dynam3d_torch.config import (
        CLIPConfig, Dynam3DConfig, FieldsConfig, LLaVAConfig, Phi3Config, SegmenterConfig,
    )
    from dynam3d_torch.models import policy

    cfg = Dynam3DConfig(
        fields=FieldsConfig(input_height=4, input_width=4, fts_dim=64, patch_capacity=256,
                            instance_capacity=64, zone_capacity=32, max_segments=8,
                            max_members=32, max_zone_members=16),
        clip=CLIPConfig(image_size=56, patch_size=14, vision_width=64, vision_layers=2,
                        vision_heads=2, embed_dim=64),
        llava=LLaVAConfig(phi3=Phi3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                                          num_layers=2, num_heads=2, num_kv_heads=2,
                                          head_dim=32, pad_token_id=260, end_token_id=257),
                          projector_hidden=64, prefill_bucket=64, max_new_tokens=8),
        segmenter=dataclasses.replace(SegmenterConfig(), imgsz=32, width_mult=0.125,
                                      depth_mult=0.34, num_protos=8, max_masks=8),
    )
    assert SegmenterConfig().provider == cfg.segmenter.provider == "yolov8"
    params = policy.init_policy_params(0, cfg, device="cpu")
    assert params["yolo"]["stem"]["w"].shape == (8, 3, 3, 3)      # OIHW

    def refuse(*a, **k):
        raise AssertionError("depth_plane_segments ran under the yolov8 provider")

    monkeypatch.setattr(policy, "depth_plane_segments", refuse)
    rng = torch.Generator().manual_seed(0)
    out = policy.perceive(params, cfg, policy.batched_init_state(cfg, 1, "cpu"),
                          torch.randint(0, 255, (1, 1, 56, 56, 3), generator=rng).to(torch.uint8),
                          torch.rand(1, 1, 32, 32, generator=rng) * 0.8 + 0.1,
                          torch.tensor([[1.0, 1.25, 2.0]]), torch.tensor([0.3]))
    assert bool(out.mm_valid.any())


def test_stream_kernel_wrappers_refuse_cpu_tensors():
    from dynam3d_torch.ops.int4_stream import int4_stream_matvec_cuda, int4_unpack_matvec_cuda

    q4 = torch.zeros(2, 256, 1024, dtype=torch.int8)
    s = torch.ones(2, 2, 1024)
    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        int4_stream_matvec_cuda(x, q4, s, s, S=2, nblk=512, dblk=128)
    for body in ("dma-floor", "current", "andtrick"):
        with pytest.raises(ValueError, match="CUDA"):
            int4_unpack_matvec_cuda(x, q4, s, s, body=body, dblk=128)
    with pytest.raises(ValueError, match="CUDA"):
        int4_unpack_matvec_cuda(x.to(torch.int8), q4, s, s, body="w4a8", dblk=128)


@pytest.mark.parametrize("tool", ["bench_int4_stream", "bench_int4_unpack"])
def test_tools_raise_without_a_card(tool, monkeypatch):
    """The tools time the card: without one they raise, in process and as
    ``python -m``, before any plain version runs."""
    import importlib

    from dynam3d_torch.ops import kernels

    mod = importlib.import_module(f"dynam3d_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.sweep(device="cpu")
    assert not any(kernels.plain_calls.values()) and not any(kernels.launches.values())
    out = subprocess.run([sys.executable, "-m", f"dynam3d_torch.tools.{tool}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr and "us/mv" not in out.stdout
