"""The multi-process dry run: five checks of the parallel layer on ``n``
ranks at a tiny config; port of ``__graft_entry__.py:111 dryrun_multichip``.
Beside it :func:`entry`, the single-card compile check
(``__graft_entry__.py:15-60``).

    python -m dynam3d_torch.parallel.dryrun 4 [--cpu]

The ranks form a ``dp x tp`` mesh (``tp = 2`` when ``n`` is even, ``dp = n
// tp``) and run, each printing one ``OK`` line (rank 0's are shown):

1. one IL step with Phi-3 in the split layout sharded over ``tp`` and one
   row a dp rank (``trainer_vln.make_train_step`` with ``dp`` and ``tp``):
   a finite loss;
2. tensor-parallel greedy decode of the trained Phi-3: the same ids on
   every rank;
3. the fused decode kernels ineligible for the split, sharded tree;
4. a data-parallel pretraining step on the mean loss, one scene a dp rank
   (``trainer_3dff.make_pretrain_step(..., dp=)``);
5. per-rank episode metrics merged with ``gather_list_and_concat`` and a
   weighted mean.

On the card the ranks share the cards there are (``nccl`` when there is one
a rank, else ``gloo``); with ``device="cpu"`` they run ``gloo`` on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device


def dryrun_config(pretrain: bool = False):
    """The dry run's tiny config (``__graft_entry__.py:142-167``): its own
    tiny YOLOv8-seg for the IL step, ``depth_plane`` and 2 x 2 novel views
    for pretraining."""
    from dynam3d_torch.config import (
        CLIPConfig, Dynam3DConfig, FieldsConfig, LLaVAConfig, Phi3Config, SegmenterConfig,
    )

    fields = dict(input_height=4, input_width=4, fts_dim=64, patch_capacity=128,
                  instance_capacity=32, zone_capacity=16, max_segments=8, max_members=16,
                  max_zone_members=8)
    if pretrain:
        fields.update(view_height=2, view_width=2)
    seg = (SegmenterConfig(provider="depth_plane", max_masks=8) if pretrain else
           SegmenterConfig(provider="yolov8", imgsz=32, width_mult=0.125, depth_mult=0.34,
                           num_protos=8, max_masks=8))
    return Dynam3DConfig(
        fields=FieldsConfig(**fields),
        clip=CLIPConfig(image_size=56, patch_size=14, vision_width=64, vision_layers=2,
                        vision_heads=2, embed_dim=64, text_context=16, text_width=32,
                        text_layers=1, text_heads=2, vocab_size=64),
        llava=LLaVAConfig(phi3=Phi3Config(vocab_size=512, hidden_size=64, intermediate_size=128,
                                          num_layers=2, num_heads=2, num_kv_heads=2,
                                          head_dim=32, pad_token_id=260, end_token_id=257),
                          projector_hidden=64, prefill_bucket=64),
        segmenter=seg,
    )


def _il_step(mesh, dev, rng):
    """Check 1; returns the trained trainable tree."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer, build_prompt
    from dynam3d_torch.parallel.mesh import (
        data_sharding, leaf_specs_like, phi3_param_specs, replicated_specs, shard_tree,
        split_qkv_params,
    )
    from dynam3d_torch.runtime import trainer_vln

    cfg = dryrun_config()
    params = policy_mod.init_policy_params(0, cfg, llm_dtype=torch.float32, device=dev)
    trainable, frozen = trainer_vln.split_params(params)
    trainable["phi3"] = split_qkv_params(trainable["phi3"], cfg.llava.phi3)
    specs = {k: replicated_specs(v) for k, v in trainable.items() if k != "phi3"}
    specs["phi3"] = phi3_param_specs(trainable["phi3"])
    trainable = shard_tree(trainable, specs, mesh)
    leaf_specs = leaf_specs_like(trainable, specs)
    opt = trainer_vln.make_optimizer(cfg)
    opt_state = opt.init(trainable, leaf_specs, mesh.tp_group)

    tok = ByteTokenizer(512)
    gt = "turn left 2 steps, move 4 steps.<|end|>"
    n_mm = 16 + policy_mod.I_ENV + policy_mod.Z_ENV
    ids = tok.encode(build_prompt("go forward", ["none\n"] * 4, n_mm, gt))
    label_ids = tok.encode(gt, add_bos=False)
    splice = ids.index(tok.image_id)
    B, T = mesh.dp, 512
    ids_a = np.full((B, T), tok.pad_id, np.int64)
    val_a = np.zeros((B, T), bool)
    ids_a[:, : len(ids)] = ids
    val_a[:, : len(ids)] = True
    rows = data_sharding(mesh, B)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a[rows]), device=dev)  # noqa: E731
    batch = trainer_vln.TrainBatch(
        rgb=put(rng.integers(0, 255, (B, 1, 56, 56, 3), dtype=np.uint8)),
        depth=put(rng.uniform(0.05, 0.9, (B, 1, 32, 32)).astype(np.float32)),
        position=put(np.tile(np.float32([1.0, 1.25, 2.0]), (B, 1))),
        heading=put(np.zeros((B,), np.float32)),
        input_ids=put(ids_a), text_valid=put(val_a),
        label_ids=put(np.tile(label_ids, (B, 1)).astype(np.int64)),
        label_mask=put(np.ones((B, len(label_ids)), bool)),
        turn_weight=put(np.ones((B,), np.float32)),
    )
    step = trainer_vln.make_train_step(cfg, opt, splice, dp=mesh.dp_group, tp=mesh.tp_group,
                                       specs=leaf_specs)
    trainable, _, _, m = step(trainable, frozen, opt_state,
                              policy_mod.batched_init_state(cfg, 1, dev), batch)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    line = (f"dryrun_multichip OK: mesh dp={mesh.dp} tp={mesh.tp}, loss={loss:.4f}, "
            f"grad_norm={float(m['grad_norm']):.4f}")
    return cfg, trainable, line


def _decode(cfg, trainable, mesh, dev, rng) -> List[str]:
    """Checks 2 and 3."""
    from dynam3d_torch.models.vlm import phi3

    p3cfg, p3 = cfg.llava.phi3, trainable["phi3"]
    ids = torch.as_tensor(rng.integers(2, 300, (mesh.dp, 12)), device=dev)
    valid = torch.ones(mesh.dp, 12, dtype=torch.bool, device=dev)
    emb = phi3.embed(p3, ids, mesh.tp_group)
    gen = phi3.greedy_decode(p3, p3cfg, emb, valid, 4, tp=mesh.tp_group).cpu()
    if tuple(gen.shape) != (mesh.dp, 4):
        raise AssertionError(f"decode shape {tuple(gen.shape)}")
    if phi3._fused_decode_eligible(p3, p3cfg, 1):
        raise AssertionError("fused decode must be ineligible for split, sharded params")
    return [f"dryrun generate OK: tp-sharded greedy tokens {gen[0].tolist()}",
            "dryrun decode-fallback OK: fused kernels ineligible -> dense path"]


def _pretrain(mesh, dev) -> str:
    """Check 4: one scene a dp rank, the gradient of the mean loss."""
    from dynam3d_torch.models.encoders.clip import init_clip_params
    from dynam3d_torch.models.memory3d import init_field_params, init_state
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.runtime import trainer_3dff
    from dynam3d_torch.runtime.pretrain_loop import PretrainRunner, SyntheticFramesDataset

    cfg = dryrun_config(pretrain=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = {"fields": init_field_params(gen, cfg.fields, dev),
              "render": init_render_params(gen, cfg.fields, dev)}
    clip = init_clip_params(gen, cfg.clip, dev)
    runner = PretrainRunner({**params, "clip": clip}, cfg, device=dev)
    ds = SyntheticFramesDataset(rgb_size=56, depth_size=32, frames=2)
    scenes = [ds.sample_scene() for _ in range(mesh.dp)]
    batch = runner.build_batch(scenes[mesh.dp_rank], clip)
    opt = trainer_3dff.make_pretrain_optimizer(cfg)
    step = trainer_3dff.make_pretrain_step(cfg, opt, posed="intrinsics" in scenes[0],
                                           dp=mesh.dp_group)
    _, _, _, m = step(params, opt.init(params), init_state(cfg.fields, dev), batch)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"pretrain dryrun loss not finite: {loss}")
    return f"dryrun pretrain OK: dp={mesh.dp} mean loss={loss:.4f}"


def _eval_aggregation(mesh) -> str:
    """Check 5: per-replica (sum, count) of episode metrics -> the weighted
    mean over every replica (ss_trainer_Dynam3D.py:389-408)."""
    from dynam3d_torch.utils.misc import gather_list_and_concat

    rng = np.random.default_rng(3)
    counts = rng.integers(1, 5, size=(mesh.dp,)).astype(np.float32)
    sums = (rng.uniform(0, 1, size=(mesh.dp, 3)) * counts[:, None]).astype(np.float32)
    mine = np.concatenate([sums[mesh.dp_rank], counts[mesh.dp_rank: mesh.dp_rank + 1]])
    rows = gather_list_and_concat(mine[None], group=mesh.dp_group)
    got = rows[:, :3].sum(0) / rows[:, 3].sum()
    expect = sums.sum(0) / counts.sum()
    if not np.allclose(got, expect, rtol=1e-5):
        raise AssertionError(f"merged metrics {got} != {expect}")
    return f"dryrun eval-agg OK: gathered-weighted metrics {np.round(expect, 4).tolist()}"


def _rank_checks(rank: int, world: int, dev: torch.device) -> List[str]:
    from dynam3d_torch.parallel.mesh import make_mesh

    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(world // tp, tp)
    rng = np.random.default_rng(0)
    cfg, trainable, line = _il_step(mesh, dev, rng)
    lines = [line] + _decode(cfg, trainable, mesh, dev, rng)
    lines.append(_pretrain(mesh, dev))
    lines.append(_eval_aggregation(mesh))
    return lines


def compile_check_config():
    """Real feature widths at a reduced depth (``__graft_entry__.py:15-38``):
    8192 / 512 / 256 table slots, 4 CLIP vision layers, 4 Phi-3 layers,
    YOLOv8-seg at FastSAM-x widths and imgsz 576 at a third of its depth."""
    from dynam3d_torch.config import (
        CLIPConfig, Dynam3DConfig, FieldsConfig, LLaVAConfig, Phi3Config, SegmenterConfig,
    )

    return Dynam3DConfig(
        fields=FieldsConfig(patch_capacity=8192, instance_capacity=512, zone_capacity=256,
                            max_segments=32, max_members=256, max_zone_members=64),
        clip=CLIPConfig(vision_layers=4, text_layers=2),
        llava=LLaVAConfig(phi3=Phi3Config(num_layers=4), max_new_tokens=20),
        segmenter=SegmenterConfig(depth_mult=0.34),
    )


def entry(cfg=None, device: DeviceLike = None):
    """``(fn, args)``: the perceive step of the VLN policy
    (``fn(*args) -> (mm_tokens, mm_valid)``) at :func:`compile_check_config`
    (or ``cfg``) on the card, or on ``device``; weights from seed 0, one
    view of ``cfg.clip.image_size``² RGB and 256² depth from numpy seed 0."""
    from dynam3d_torch.models import policy

    dev = resolve_device(device)
    cfg = cfg or compile_check_config()
    params = policy.init_policy_params(0, cfg, device=dev)
    state = policy.batched_init_state(cfg, 1, dev)
    rng = np.random.default_rng(0)
    size = cfg.clip.image_size
    rgb = torch.as_tensor(rng.integers(0, 255, (1, 1, size, size, 3), dtype=np.uint8),
                          device=dev)
    depth = torch.as_tensor(rng.uniform(0.05, 0.95, (1, 1, 256, 256)).astype(np.float32),
                            device=dev)
    pos = torch.tensor([[1.0, 1.25, 2.0]], device=dev)
    hd = torch.zeros(1, device=dev)

    def fn(params, state, rgb, depth, pos, hd):
        out = policy.perceive(params, cfg, state, rgb, depth, pos, hd)
        return out.mm_tokens, out.mm_valid

    return fn, (params, state, rgb, depth, pos, hd)


def dryrun_multichip(n: int, device: DeviceLike = None, timeout: float = 900.0) -> List[str]:
    """The five checks on ``n`` spawned ranks; prints and returns rank 0's
    ``OK`` lines (every rank's checks must pass)."""
    from dynam3d_torch.parallel.spawn import run_ranks

    dev = resolve_device(device)
    kind = "cpu" if dev.type == "cpu" else "cuda"
    backend = "nccl" if kind == "cuda" and torch.cuda.device_count() >= n else "gloo"
    lines = run_ranks(_rank_checks, n, device=kind, backend=backend, timeout=timeout)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
