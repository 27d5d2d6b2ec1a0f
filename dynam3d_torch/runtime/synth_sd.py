"""Reference-format torch state dicts synthesized from the port's trees;
port of ``runtime/synth_sd.py``.

The reference's assets (``dynam3d.pth``, ``xtuner/llava-phi-3-mini-hf``,
``ViT-L-14-336px``, ``FastSAM.pt``, ``check_cwp_bestdist_hfov90``,
``gibson-2plus-resnet50.pth``) are not in the repo.  These functions write
state dicts under the reference's exact key names and tensor layouts, the
inverse of every converter in ``runtime.checkpoint``, at any size, so that
``convert(synth(params)) == params`` proves key names, shapes, dtypes and
transposes end to end; real assets then take the same converters.

Values are torch tensors on the tree's device.  The Phi-3 leaves keep the
tree's dtype (bf16 matrices, as the HF asset stores them, and float32
norms); every other leaf is float32.  Convolution weights are OIHW in both.

Key-name sources:
  - Feature_Fields: vlnce_baselines/models/feature_fields.py:139-161 (VLN)
    and src_3dff/models/feature_fields.py:173-256 (pretrain + render heads);
  - policy projectors: Policy_Dynam3D_VLN.py:83-111;
  - LLaVA: HF ``LlavaForConditionalGeneration`` with transformers >= 4.52
    naming (tower, projector and LM nested under ``model.``);
  - CLIP: OpenAI vendored layout (clip/model.py);
  - FastSAM: ultralytics ``model.model.N`` indexing;
  - waypoint: waypoint_pred/TRM_net.py:9-88;
  - DD-PPO depth: habitat gibson-2plus ResNet-50 (resnet_encoders.py:40-52).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from dynam3d_torch.runtime.checkpoint import PROJECTORS

SD = Dict[str, torch.Tensor]


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.float()


def _tt(a: torch.Tensor) -> torch.Tensor:
    """The float32 transpose of a 2-D leaf, as a contiguous tensor."""
    return a.float().t().contiguous()


# --------------------------------------------------------------------------
# primitive inverses (of runtime.checkpoint converters)
# --------------------------------------------------------------------------
def dense_sd(p: Mapping, out: SD, prefix: str) -> None:
    out[f"{prefix}.weight"] = _tt(p["w"])
    out[f"{prefix}.bias"] = _t(p["b"])


def ln_sd(p: Mapping, out: SD, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def mlp2_sd(p: Mapping, out: SD, prefix: str) -> None:
    """nn.Sequential(Linear, LayerNorm, GELU, Linear) indices 0/1/3."""
    dense_sd(p["fc1"], out, f"{prefix}.0")
    ln_sd(p["ln"], out, f"{prefix}.1")
    dense_sd(p["fc2"], out, f"{prefix}.3")


def encoder_layer_sd(p: Mapping, out: SD, prefix: str) -> None:
    """nn.TransformerEncoderLayer with fused in_proj."""
    out[f"{prefix}.self_attn.in_proj_weight"] = _tt(p["attn"]["qkv"]["w"])
    out[f"{prefix}.self_attn.in_proj_bias"] = _t(p["attn"]["qkv"]["b"])
    dense_sd(p["attn"]["out"], out, f"{prefix}.self_attn.out_proj")
    ln_sd(p["ln1"], out, f"{prefix}.norm1")
    dense_sd(p["ff1"], out, f"{prefix}.linear1")
    dense_sd(p["ff2"], out, f"{prefix}.linear2")
    ln_sd(p["ln2"], out, f"{prefix}.norm2")


def encoder_stack_sd(p: Mapping, out: SD, prefix: str, final_ln: str) -> None:
    for i, lp in enumerate(p["layers"]):
        encoder_layer_sd(lp, out, f"{prefix}.layers.{i}")
    ln_sd(p["final_ln"], out, final_ln)


def _split_rows(w: torch.Tensor, b: torch.Tensor, names, out: SD, prefix: str) -> None:
    """A fused ``[in, 3D]`` dense -> three torch Linears ``{prefix}.{name}``."""
    wt, bf = _tt(w), _t(b)
    D = wt.shape[1]
    for j, name in enumerate(names):
        out[f"{prefix}.{name}.weight"] = wt[j * D:(j + 1) * D].clone()
        out[f"{prefix}.{name}.bias"] = bf[j * D:(j + 1) * D].clone()


# --------------------------------------------------------------------------
# Feature_Fields (dynam3d.pth) + render heads (pretrain ckpt)
# --------------------------------------------------------------------------
def fields_sd(params: Mapping) -> SD:
    out: SD = {}
    mlp2_sd(params["patch_pos_mlp"], out, "patch_to_instance_position_embedding")
    out["aggregate_patch_to_instance_embedding"] = _t(params["p2i_agg_token"])
    encoder_stack_sd(params["p2i_encoder"], out, "aggregate_patch_to_instance_encoder",
                     "aggregate_patch_to_instance_encoder.norm")
    mlp2_sd(params["inst_pos_mlp"], out, "instance_to_zone_position_embedding")
    out["aggregate_instance_to_zone_embedding"] = _t(params["i2z_agg_token"])
    encoder_stack_sd(params["i2z_encoder"], out, "aggregate_instance_to_zone_encoder",
                     "aggregate_instance_to_zone_encoder.norm")
    mlp2_sd(params["merge_disc"], out, "instance_merge_discriminator")
    return out


def _ceil16(n: int) -> int:
    return ((n + 15) // 16) * 16


def _tcnn_flat(mats, n_in: int, n_out: int) -> torch.Tensor:
    """Inverse of ``checkpoint.tcnn_mlp_from_flat``: per-layer ``[in, out]``
    matrices -> one flat row-major vector, the network's in and out widths
    padded to 16."""
    neurons = mats[0].shape[1]
    dev = mats[0].device
    m0 = torch.zeros(neurons, _ceil16(n_in), device=dev)
    m0[:, :n_in] = _t(mats[0]).t()
    ml = torch.zeros(_ceil16(n_out), neurons, device=dev)
    ml[:n_out, :] = _t(mats[-1]).t()
    return torch.cat([m0.reshape(-1)] + [_tt(m).reshape(-1) for m in mats[1:-1]]
                     + [ml.reshape(-1)])


def render_sd(render_params: Mapping, cfg) -> SD:
    """Renderer heads in the pretrain checkpoint's naming
    (src_3dff feature_fields.py:218-256); ``cfg.mlp_net_width`` must equal
    the width of the matrices (768 for both in the reference)."""
    mlp = render_params["mlp"]
    d = int(mlp["enc_hidden"][0].shape[0])
    if d != cfg.mlp_net_width:
        raise ValueError(f"render params width {d} != cfg.mlp_net_width {cfg.mlp_net_width}")
    out: SD = {
        "nerf_encoder.params": _tcnn_flat(list(mlp["enc_hidden"]) + [mlp["enc_out"]], d, d + 1),
        "nerf_decoder.params": _tcnn_flat(list(mlp["dec_hidden"]) + [mlp["dec_out"]], d, d),
    }
    dense_sd({"w": render_params["pos_w"], "b": render_params["pos_b"]}, out,
             "patch_to_nerf_position_embedding.0")
    ln_sd(render_params["pos_ln"], out, "patch_to_nerf_position_embedding.1")
    dense_sd({"w": render_params["agg_w"], "b": render_params["agg_b"]}, out,
             "aggregate_patch_to_nerf_encoder.0")
    ln_sd(render_params["agg_ln"], out, "aggregate_patch_to_nerf_encoder.1")
    return out


# --------------------------------------------------------------------------
# OpenAI CLIP (vendored layout)
# --------------------------------------------------------------------------
def _clip_block_sd(p: Mapping, out: SD, prefix: str) -> None:
    out[f"{prefix}.attn.in_proj_weight"] = _tt(p["attn"]["qkv"]["w"])
    out[f"{prefix}.attn.in_proj_bias"] = _t(p["attn"]["qkv"]["b"])
    dense_sd(p["attn"]["out"], out, f"{prefix}.attn.out_proj")
    ln_sd(p["ln1"], out, f"{prefix}.ln_1")
    ln_sd(p["ln2"], out, f"{prefix}.ln_2")
    dense_sd(p["fc1"], out, f"{prefix}.mlp.c_fc")
    dense_sd(p["fc2"], out, f"{prefix}.mlp.c_proj")


def _conv_flat_to_torch(conv_flat: torch.Tensor, patch: int) -> torch.Tensor:
    """``[P*P*3, W]`` patchify matrix -> torch ``[W, 3, P, P]``."""
    W = conv_flat.shape[1]
    return _t(conv_flat).reshape(patch, patch, 3, W).permute(3, 2, 0, 1).contiguous()


def clip_sd(params: Mapping, patch_size: int = 14) -> SD:
    out: SD = {}
    v = params["visual"]
    out["visual.conv1.weight"] = _conv_flat_to_torch(v["conv1_w"], patch_size)
    out["visual.class_embedding"] = _t(v["class_embedding"])
    out["visual.positional_embedding"] = _t(v["positional_embedding"])
    ln_sd(v["ln_pre"], out, "visual.ln_pre")
    for i, blk in enumerate(v["transformer"]["blocks"]):
        _clip_block_sd(blk, out, f"visual.transformer.resblocks.{i}")
    ln_sd(v["ln_post"], out, "visual.ln_post")
    out["visual.proj"] = _t(v["proj"])
    t = params["text"]
    out["token_embedding.weight"] = _t(t["token_embedding"])
    out["positional_embedding"] = _t(t["positional_embedding"])
    for i, blk in enumerate(t["transformer"]["blocks"]):
        _clip_block_sd(blk, out, f"transformer.resblocks.{i}")
    ln_sd(t["ln_final"], out, "ln_final")
    out["text_projection"] = _t(t["projection"])
    out["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32,
                                      device=v["conv1_w"].device)
    return out


# --------------------------------------------------------------------------
# LLaVA-Phi-3 (HF >= 4.52 naming: model.-nested tower / projector / LM)
# --------------------------------------------------------------------------
def llava_sd(params: Mapping, num_vision_layers: int, patch_size: int = 14) -> SD:
    out: SD = {}
    vt = "model.vision_tower.vision_model"
    c = params["clip"]["visual"]
    out[f"{vt}.embeddings.patch_embedding.weight"] = _conv_flat_to_torch(c["conv1_w"],
                                                                         patch_size)
    out[f"{vt}.embeddings.class_embedding"] = _t(c["class_embedding"])
    out[f"{vt}.embeddings.position_embedding.weight"] = _t(c["positional_embedding"])
    ln_sd(c["ln_pre"], out, f"{vt}.pre_layrnorm")  # [sic] HF typo
    ln_sd(c["ln_post"], out, f"{vt}.post_layernorm")
    for i, blk in enumerate(c["transformer"]["blocks"][:num_vision_layers]):
        p = f"{vt}.encoder.layers.{i}"
        _split_rows(blk["attn"]["qkv"]["w"], blk["attn"]["qkv"]["b"],
                    ("q_proj", "k_proj", "v_proj"), out, f"{p}.self_attn")
        dense_sd(blk["attn"]["out"], out, f"{p}.self_attn.out_proj")
        ln_sd(blk["ln1"], out, f"{p}.layer_norm1")
        ln_sd(blk["ln2"], out, f"{p}.layer_norm2")
        dense_sd(blk["fc1"], out, f"{p}.mlp.fc1")
        dense_sd(blk["fc2"], out, f"{p}.mlp.fc2")
    dense_sd(params["projector"]["fc1"], out, "model.multi_modal_projector.linear_1")
    dense_sd(params["projector"]["fc2"], out, "model.multi_modal_projector.linear_2")
    lm = "model.language_model"
    p3 = params["phi3"]
    # the Phi-3 leaves keep the tree's dtype (bf16 matrices, f32 norms)
    out[f"{lm}.embed_tokens.weight"] = p3["embed_tokens"]
    for i, lp in enumerate(p3["layers"]):
        p = f"{lm}.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = lp["input_ln"]
        out[f"{p}.self_attn.qkv_proj.weight"] = lp["qkv"].t().contiguous()
        out[f"{p}.self_attn.o_proj.weight"] = lp["o"].t().contiguous()
        out[f"{p}.post_attention_layernorm.weight"] = lp["post_ln"]
        out[f"{p}.mlp.gate_up_proj.weight"] = lp["gate_up"].t().contiguous()
        out[f"{p}.mlp.down_proj.weight"] = lp["down"].t().contiguous()
    out[f"{lm}.norm.weight"] = p3["final_ln"]
    out["lm_head.weight"] = p3["lm_head"].t().contiguous()
    return out


# --------------------------------------------------------------------------
# FastSAM / YOLOv8-seg (ultralytics model.model.N naming, BN un-folded)
# --------------------------------------------------------------------------
def _conv_bn_sd(p: Mapping, out: SD, prefix: str, eps: float = 1e-3) -> None:
    """Conv + BN whose fold (``checkpoint.conv_bn_from_torch``) gives back
    the folded ``{w, b}`` exactly: gamma = 1, var = 1 - eps, so scale = 1."""
    b = _t(p["b"])
    O, dev = b.shape[0], b.device
    out[f"{prefix}.conv.weight"] = _t(p["w"])
    out[f"{prefix}.bn.weight"] = torch.ones(O, device=dev)
    out[f"{prefix}.bn.bias"] = b
    out[f"{prefix}.bn.running_mean"] = torch.zeros(O, device=dev)
    out[f"{prefix}.bn.running_var"] = torch.full((O,), 1.0 - eps, device=dev)


def _plain_conv_sd(p: Mapping, out: SD, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(p["w"])
    out[f"{prefix}.bias"] = _t(p["b"])


def _c2f_sd(p: Mapping, out: SD, prefix: str) -> None:
    _conv_bn_sd(p["cv1"], out, f"{prefix}.cv1")
    for i, m in enumerate(p["m"]):
        _conv_bn_sd(m["cv1"], out, f"{prefix}.m.{i}.cv1")
        _conv_bn_sd(m["cv2"], out, f"{prefix}.m.{i}.cv2")
    _conv_bn_sd(p["cv2"], out, f"{prefix}.cv2")


def fastsam_sd(params: Mapping) -> SD:
    out: SD = {}
    m = "model.model"
    for name, idx in (("stem", 0), ("down1", 1), ("c2f1", 2), ("down2", 3), ("c2f2", 4),
                      ("down3", 5), ("c2f3", 6), ("down4", 7), ("c2f4", 8)):
        if name.startswith("c2f"):
            _c2f_sd(params[name], out, f"{m}.{idx}")
        else:
            _conv_bn_sd(params[name], out, f"{m}.{idx}")
    _conv_bn_sd(params["sppf"]["cv1"], out, f"{m}.9.cv1")
    _conv_bn_sd(params["sppf"]["cv2"], out, f"{m}.9.cv2")
    for name, idx in (("neck1", 12), ("neck2", 15), ("neck3", 18), ("neck4", 21)):
        _c2f_sd(params[name], out, f"{m}.{idx}")
    _conv_bn_sd(params["pan1"], out, f"{m}.16")
    _conv_bn_sd(params["pan2"], out, f"{m}.19")
    for cv in ("cv1", "cv2", "cv3"):
        _conv_bn_sd(params["proto"][cv], out, f"{m}.22.proto.{cv}")
    for i, det in enumerate(params["det"]):
        _conv_bn_sd(det["box0"], out, f"{m}.22.cv2.{i}.0")
        _conv_bn_sd(det["box1"], out, f"{m}.22.cv2.{i}.1")
        _plain_conv_sd(det["box2"], out, f"{m}.22.cv2.{i}.2")
        _conv_bn_sd(det["cls0"], out, f"{m}.22.cv3.{i}.0")
        _conv_bn_sd(det["cls1"], out, f"{m}.22.cv3.{i}.1")
        _plain_conv_sd(det["cls2"], out, f"{m}.22.cv3.{i}.2")
        _conv_bn_sd(det["m0"], out, f"{m}.22.cv4.{i}.0")
        _conv_bn_sd(det["m1"], out, f"{m}.22.cv4.{i}.1")
        _plain_conv_sd(det["m2"], out, f"{m}.22.cv4.{i}.2")
    return out


# --------------------------------------------------------------------------
# Waypoint TRM (check_cwp_bestdist_hfov90)
# --------------------------------------------------------------------------
def waypoint_sd(params: Mapping) -> SD:
    out: SD = {}
    dense_sd(params["visual_fc_depth"], out, "visual_fc_depth.1")
    for i, lp in enumerate(params["bert_layers"]):
        p = f"waypoint_TRM.bert.encoder.layer.{i}"
        _split_rows(lp["attn"]["qkv"]["w"], lp["attn"]["qkv"]["b"], ("query", "key", "value"),
                    out, f"{p}.attention.self")
        dense_sd(lp["attn"]["out"], out, f"{p}.attention.output.dense")
        ln_sd(lp["ln1"], out, f"{p}.attention.output.LayerNorm")
        dense_sd(lp["ff1"], out, f"{p}.intermediate.dense")
        dense_sd(lp["ff2"], out, f"{p}.output.dense")
        ln_sd(lp["ln2"], out, f"{p}.output.LayerNorm")
    dense_sd(params["cls_fc1"], out, "vis_classifier.0")
    dense_sd(params["cls_fc2"], out, "vis_classifier.2")
    return out


# --------------------------------------------------------------------------
# DD-PPO depth ResNet-50 (gibson-2plus)
# --------------------------------------------------------------------------
def ddppo_sd(params: Mapping, prefix: str = "actor_critic.net.visual_encoder.") -> SD:
    out: SD = {}

    def conv(p, name):
        out[f"{prefix}{name}.weight"] = _t(p["w"])

    def gn(p, name):
        out[f"{prefix}{name}.weight"] = _t(p["scale"])
        out[f"{prefix}{name}.bias"] = _t(p["bias"])

    conv(params["stem_conv"], "backbone.conv1.0")
    gn(params["stem_gn"], "backbone.conv1.1")
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            b = f"backbone.layer{si + 1}.{bi}"
            conv(blk["conv1"], f"{b}.convs.0")
            gn(blk["gn1"], f"{b}.convs.1")
            conv(blk["conv2"], f"{b}.convs.3")
            gn(blk["gn2"], f"{b}.convs.4")
            conv(blk["conv3"], f"{b}.convs.6")
            gn(blk["gn3"], f"{b}.convs.7")
            if "down_conv" in blk:
                conv(blk["down_conv"], f"{b}.downsample.0")
                gn(blk["down_gn"], f"{b}.downsample.1")
    conv(params["compress_conv"], "compression.0")
    gn(params["compress_gn"], "compression.1")
    return out


# --------------------------------------------------------------------------
# VLN trainer checkpoint (ckpt.iterN.pth): the whole policy under "net."
# --------------------------------------------------------------------------
def _vln_ckpt(policy_params: Mapping, fields: SD, llava: SD) -> SD:
    out: SD = {f"net.feature_fields.{k}": v for k, v in fields.items()}
    for ours, theirs in PROJECTORS:
        mlp2_sd(policy_params[ours], out, f"net.{theirs}")
    out.update({f"net.llava.{k}": v for k, v in llava.items()})
    return out


def vln_ckpt_sd(policy_params: Mapping, num_vision_layers: int) -> SD:
    """The reference trainer saves ``{"state_dict": policy.state_dict(), ...}``
    with every submodule under ``net.`` (ss_trainer_Dynam3D.py:75-84): the 5
    projector MLPs (Policy_Dynam3D_VLN.py:83-111), the llava module and the
    frozen feature_fields."""
    return _vln_ckpt(policy_params, fields_sd(policy_params["fields"]),
                     llava_sd(policy_params["llava"], num_vision_layers))


def synth_all(params: Mapping, cfg, render_params=None, waypoint_params=None,
              depth_params=None) -> Dict[str, SD]:
    """Every reference asset family derivable from a policy tree (plus the
    renderer, waypoint and depth trees when given).  The trainer checkpoint
    shares its tensors with the ``dynam3d`` and ``llava`` assets."""
    fields = fields_sd(params["fields"])
    llava = llava_sd(params["llava"], cfg.clip.vision_layers, cfg.clip.patch_size)
    out = {
        "dynam3d": fields,
        "clip": clip_sd(params["clip"], cfg.clip.patch_size),
        "llava": llava,
        "vln_ckpt": _vln_ckpt(params, fields, llava),
    }
    if "yolo" in params:
        out["fastsam"] = fastsam_sd(params["yolo"])
    if render_params is not None:
        pretrain = {f"net.feature_fields.{k}": v for k, v in fields.items()}
        pretrain.update({f"net.feature_fields.{k}": v
                         for k, v in render_sd(render_params, cfg.fields).items()})
        out["pretrain"] = pretrain
    if waypoint_params is not None:
        out["waypoint"] = waypoint_sd(waypoint_params)
    if depth_params is not None:
        out["ddppo"] = ddppo_sd(depth_params)
    return out
