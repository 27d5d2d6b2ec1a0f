"""One-command conversion of the reference's torch assets into a checkpoint
the port loads; port of ``tools/convert_reference_ckpt.py``.

    python -m dynam3d_torch.tools.convert_reference_ckpt --out data/converted \\
        [--exp-config cfg.json] \\
        [--dynam3d dynam3d.pth]                # Feature_Fields (VLN)
        [--pretrain ckpt.iter80000.pth]        # 3DFF pretrain (fields + render)
        [--vln ckpt.iter100000.pth]            # VLN trainer checkpoint (net.)
        [--llava llava-phi-3-mini.pth]         # HF LLaVA state dict
        [--clip ViT-L-14-336px.pth]            # OpenAI CLIP state dict
        [--fastsam FastSAM.pth]                # ultralytics FastSAM
        [--waypoint check_cwp_bestdist_hfov90] [--ddppo gibson-2plus-resnet50.pth]

Each asset is optional: whatever is given is converted, the rest of the
policy tree comes from ``init_policy_params(0, cfg)`` and the renderer from
``init_render_params`` (seed 1), so the result is always complete.  The
conversion runs on the card (``main(argv, device="cpu")`` on the host);
``ckpt.iter0`` under ``--out`` holds ``{"params", "render", ["waypoint"],
["depth_enc"]}``, read back by ``runtime.checkpoint.load_to_device``;
``main`` returns its path, the report, the policy's parameter count and
the seconds of the conversion (reading included) and of the save.
"""

from __future__ import annotations

import argparse
import time
import zipfile

import torch

from dynam3d_torch.device import DeviceLike, resolve_device

ASSETS = ("dynam3d", "pretrain", "vln", "llava", "clip", "fastsam", "waypoint", "ddppo")


def _load_sd(path):
    """A state dict from an in-memory mapping or a ``torch.load``-able file.

    Files load with ``weights_only=False``: the reference's trainer
    checkpoints and ultralytics' ``FastSAM.pt`` hold objects that are not
    tensors (optimizer state, config namespaces, the model object), so only
    load files you trust.  A zip-format file is memory-mapped.  A module is
    replaced by its ``state_dict()``, and ``{"state_dict": ...}`` and
    ``{"model": module}`` wrappers are unwrapped."""
    if isinstance(path, dict):
        return path
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     mmap=zipfile.is_zipfile(path))
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        obj = obj["model"].state_dict()
    return obj


def _llava_from_torch(sd, cfg, text_tower, dev):
    """The LLaVA tree of an HF state dict; the HF checkpoint has no text
    tower, so ``text_tower`` (LLaVA never runs it) is kept."""
    from dynam3d_torch.runtime import checkpoint as ck

    return {
        "clip": {"visual": ck.clip_vision_from_hf(sd, cfg.clip.vision_layers, dev),
                 "text": text_tower},
        "projector": ck.llava_projector_from_torch(sd, dev),
        "phi3": ck.phi3_params_from_torch(sd, cfg.llava.phi3.num_layers, device=dev),
    }


def convert(cfg, paths: dict, device: DeviceLike = None):
    """The full policy tree on ``device`` (``None``: the card), the given
    assets converted over a random one; returns ``(params, extras, report)``
    with ``extras["render"]`` and, when given, ``extras["waypoint"]`` and
    ``extras["depth_enc"]``, and ``report`` naming each part's source."""
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.models.render.nerf import init_render_params
    from dynam3d_torch.runtime import checkpoint as ck

    dev = resolve_device(device)
    params = policy_mod.init_policy_params(0, cfg, device=dev)
    render = init_render_params(torch.Generator(device=dev).manual_seed(1), cfg.fields, dev)
    report = {}

    if paths.get("dynam3d"):
        params["fields"] = ck.field_params_from_torch(_load_sd(paths["dynam3d"]), dev)
        report["fields"] = "dynam3d"
    if paths.get("pretrain"):
        sd = ck.strip_prefix(_load_sd(paths["pretrain"]), "net.feature_fields.")
        params["fields"] = ck.field_params_from_torch(sd, dev)
        render = ck.render_params_from_torch(sd, cfg.fields, dev)
        report["fields"] = report["render"] = "pretrain"
    if paths.get("clip"):
        params["clip"] = ck.clip_params_from_torch(_load_sd(paths["clip"]), cfg.clip.vision_layers,
                                                   cfg.clip.text_layers, dev)
        report["clip"] = "clip"
    if paths.get("llava"):
        params["llava"] = _llava_from_torch(_load_sd(paths["llava"]), cfg,
                                            params["llava"]["clip"]["text"], dev)
        report["llava"] = "llava"
    if paths.get("vln"):
        # trainer checkpoint ckpt.iterN.pth: the whole policy under "net."
        # (ss_trainer_Dynam3D.py:75-84); DDP runs leave "net.module.".
        sd = ck.strip_prefix(_load_sd(paths["vln"]), "net.")
        sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

        fields_part = sub("feature_fields.")
        if fields_part:
            params["fields"] = ck.field_params_from_torch(fields_part, dev)
            report["fields"] = "vln"
        llava_part = sub("llava.")
        if llava_part:
            params["llava"] = _llava_from_torch(llava_part, cfg, params["llava"]["clip"]["text"],
                                                dev)
            report["llava"] = "vln"
        for ours, theirs in ck.PROJECTORS:
            if f"{theirs}.0.weight" in sd:
                params[ours] = ck.mlp2_from_torch(sd, theirs, dev)
                report[ours] = "vln"
    if paths.get("fastsam"):
        params["yolo"] = ck.yolov8_params_from_torch(
            _load_sd(paths["fastsam"]), depth_n=cfg.segmenter.depth_layers(), device=dev)
        report["yolo"] = "fastsam"
    extras = {"render": render}
    if paths.get("waypoint"):
        extras["waypoint"] = ck.waypoint_params_from_torch(_load_sd(paths["waypoint"]),
                                                           device=dev)
        report["waypoint"] = "waypoint"
    if paths.get("ddppo"):
        sd = ck.strip_prefix(_load_sd(paths["ddppo"]), "actor_critic.net.visual_encoder.")
        extras["depth_enc"] = ck.depth_resnet_from_torch(sd, dev)
        report["depth_enc"] = "ddppo"
    return params, extras, report


def main(argv=None, device: DeviceLike = None) -> dict:
    from dynam3d_torch.config import Dynam3DConfig, load
    from dynam3d_torch.runtime.checkpoint import save_checkpoint
    from dynam3d_torch.utils.tree import tree_leaves

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--exp-config", default=None)
    for name in ASSETS:
        p.add_argument(f"--{name}", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    cfg = load(args.exp_config) if args.exp_config else Dynam3DConfig()
    t0 = time.perf_counter()
    params, extras, report = convert(cfg, {k: getattr(args, k) for k in ASSETS}, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    path = save_checkpoint(args.out, 0, {"params": params, **extras})
    out = {"path": path, "report": report,
           "policy_params": sum(int(x.numel()) for x in tree_leaves(params)),
           "convert_s": t1 - t0, "save_s": time.perf_counter() - t1}
    print(f"converted {report or '(no assets: random init)'} -> {path} "
          f"({out['policy_params'] / 1e6:.1f}M policy params; convert {out['convert_s']:.2f} s, "
          f"save {out['save_s']:.2f} s)")
    return out


if __name__ == "__main__":
    main()
