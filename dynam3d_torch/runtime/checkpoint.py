"""Checkpoints and the reference's weights; port of ``runtime/checkpoint.py``.

Two halves:

  - training checkpoints: ``ckpt.iter{N}`` files written with
    ``torch.save`` from host copies of the tensors, the newest found by
    mtime, the step read from the name;
  - converters from the reference's torch state dicts (the Feature_Fields
    modules, the renderer heads in tinycudann's flat layout, OpenAI CLIP,
    the HF LLaVA tower and projector, HF Phi-3 in its three key layouts,
    the waypoint BERT, FastSAM with its BatchNorm folded, the DD-PPO depth
    ResNet) straight into the port's parameter trees.

A converter takes a mapping of torch tensors or numpy arrays and returns
the port's tree as torch tensors on ``device`` (``None``: the card).  Each
leaf has the reference converter's dtype: float32, also for a bf16 or fp16
source, save the Phi-3 matrices, which take ``dtype`` (bf16 by default).
A bf16 source reaches bf16 leaves without a float32 copy on the host.
Convolution weights stay OIHW, as the port's convolutions take them.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.utils.tree import tree_map

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# training checkpoints
# --------------------------------------------------------------------------
def save_checkpoint(ckpt_dir: str, step: int, payload: Any) -> str:
    """Write ``payload`` (nested dicts / lists of tensors and numbers) to
    ``ckpt_dir/ckpt.iter{step}``; tensors are copied to the host first."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt.iter{step}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                        payload), path)
    return path


def load_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read a checkpoint; with ``template`` each tensor goes to the device
    and dtype of the template's tensor at the same place."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is None:
        return loaded
    return tree_map(lambda t, x: x.to(t.device, t.dtype) if isinstance(t, torch.Tensor) else x,
                    template, loaded)


def load_to_device(path: str, device: DeviceLike = None) -> Any:
    """Read a checkpoint (memory-mapped) with every tensor moved to
    ``device`` (``None``: the card), in its stored dtype."""
    dev = resolve_device(device)
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True, mmap=True)
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, loaded)


def newest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``ckpt.iter*`` in ``ckpt_dir`` by mtime, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir) if d.startswith("ckpt.iter")]
    return max(cands, key=os.path.getmtime) if cands else None


def checkpoint_step(path: str) -> int:
    """The step in a checkpoint's name, -1 if it has none."""
    m = re.search(r"iter(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


# --------------------------------------------------------------------------
# coercion and prefixes
# --------------------------------------------------------------------------
def _tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A state-dict value on ``device``: floating values in float32 (the
    reference widens bf16 / fp16 sources, and runs without float64) unless
    ``dtype`` is given; never an alias of the caller's tensor."""
    if isinstance(x, torch.Tensor):
        src = x.detach()
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":           # ml_dtypes bf16: exact through f32
            a = a.astype(np.float32)
        src = torch.from_numpy(a)
    if dtype is None:
        dtype = torch.float32 if src.is_floating_point() else src.dtype
    out = src.to(device).to(dtype)
    if out.data_ptr() == src.data_ptr() and out.device == src.device:
        out = out.clone()
    return out


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def strip_prefix(state: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """``convert_ckpt.py``: the entries under ``prefix`` with it removed,
    after dropping one leading ``module.`` (a DDP wrapper) from each key.
    The values are passed through as they are."""
    out = {}
    for k, v in state.items():
        k = k.replace("module.", "", 1) if k.startswith("module.") else k
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


# --------------------------------------------------------------------------
# primitive converters
# --------------------------------------------------------------------------
def dense_from_torch(sd: Mapping, prefix: str, device: DeviceLike = None) -> Params:
    """torch ``nn.Linear`` [out, in] -> ``{"w": [in, out], "b": [out]}``."""
    dev = resolve_device(device)
    w = _tensor(sd[_j(prefix, "weight")], dev).t().contiguous()
    b = sd.get(_j(prefix, "bias"))
    b = torch.zeros(w.shape[1], device=dev) if b is None else _tensor(b, dev)
    return {"w": w, "b": b}


def ln_from_torch(sd: Mapping, prefix: str, device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {"scale": _tensor(sd[_j(prefix, "weight")], dev),
            "bias": _tensor(sd[_j(prefix, "bias")], dev)}


def mlp2_from_torch(sd: Mapping, prefix: str, device: DeviceLike = None) -> Params:
    """``nn.Sequential(Linear, LayerNorm, GELU, Linear)`` -> mlp2 params."""
    return {"fc1": dense_from_torch(sd, _j(prefix, "0"), device),
            "ln": ln_from_torch(sd, _j(prefix, "1"), device),
            "fc2": dense_from_torch(sd, _j(prefix, "3"), device)}


def encoder_layer_from_torch(sd: Mapping, prefix: str, device: DeviceLike = None) -> Params:
    """``nn.TransformerEncoderLayer`` (post-norm) -> encoder-layer params;
    the fused ``in_proj`` becomes the ``qkv`` dense."""
    dev = resolve_device(device)
    return {
        "attn": {
            "qkv": {"w": _tensor(sd[_j(prefix, "self_attn.in_proj_weight")], dev).t().contiguous(),
                    "b": _tensor(sd[_j(prefix, "self_attn.in_proj_bias")], dev)},
            "out": dense_from_torch(sd, _j(prefix, "self_attn.out_proj"), dev),
        },
        "ln1": ln_from_torch(sd, _j(prefix, "norm1"), dev),
        "ff1": dense_from_torch(sd, _j(prefix, "linear1"), dev),
        "ff2": dense_from_torch(sd, _j(prefix, "linear2"), dev),
        "ln2": ln_from_torch(sd, _j(prefix, "norm2"), dev),
    }


def encoder_stack_from_torch(sd: Mapping, prefix: str, n_layers: int, final_ln: str,
                             device: DeviceLike = None) -> Params:
    """``nn.TransformerEncoder(layers, norm=LN)`` -> encoder-stack params."""
    return {"layers": [encoder_layer_from_torch(sd, _j(prefix, f"layers.{i}"), device)
                       for i in range(n_layers)],
            "final_ln": ln_from_torch(sd, final_ln, device)}


# --------------------------------------------------------------------------
# Feature_Fields (the 3D memory) and the renderer heads
# --------------------------------------------------------------------------
def field_params_from_torch(sd: Mapping, device: DeviceLike = None) -> Params:
    """``dynam3d.pth`` (Feature_Fields state_dict) -> memory3d params
    (module names of feature_fields.py:139-161)."""
    dev = resolve_device(device)
    return {
        "patch_pos_mlp": mlp2_from_torch(sd, "patch_to_instance_position_embedding", dev),
        "p2i_agg_token": _tensor(sd["aggregate_patch_to_instance_embedding"], dev),
        "p2i_encoder": encoder_stack_from_torch(
            sd, "aggregate_patch_to_instance_encoder", 2,
            "aggregate_patch_to_instance_encoder.norm", dev),
        "inst_pos_mlp": mlp2_from_torch(sd, "instance_to_zone_position_embedding", dev),
        "i2z_agg_token": _tensor(sd["aggregate_instance_to_zone_embedding"], dev),
        "i2z_encoder": encoder_stack_from_torch(
            sd, "aggregate_instance_to_zone_encoder", 2,
            "aggregate_instance_to_zone_encoder.norm", dev),
        "merge_disc": mlp2_from_torch(sd, "instance_merge_discriminator", dev),
    }


def _ceil16(n: int) -> int:
    return ((n + 15) // 16) * 16


def tcnn_mlp_from_flat(flat: Any, n_in: int, n_out: int, neurons: int, n_hidden: int,
                       device: DeviceLike = None) -> list:
    """A tinycudann CutlassMLP ``params`` vector -> per-layer ``[in, out]``
    float32 matrices.

    tcnn stores the network as one flat fp16 vector: row-major weight
    matrices in layer order, the network's input and output widths padded
    up to multiples of 16 (hidden layers use ``neurons`` as they are).  The
    padding is cropped and each matrix transposed."""
    dev = resolve_device(device)
    w = _tensor(flat, dev).reshape(-1)
    in_pad, out_pad = _ceil16(n_in), _ceil16(n_out)
    dims = [(neurons, in_pad)] + [(neurons, neurons)] * (n_hidden - 1) + [(out_pad, neurons)]
    mats, off = [], 0
    for o, i in dims:
        mats.append(w[off: off + o * i].reshape(o, i))
        off += o * i
    if off != w.numel():
        raise ValueError(f"tcnn flat params size {w.numel()} != layout {off} "
                         f"(in={n_in}, out={n_out}, neurons={neurons}, hidden={n_hidden})")
    out = [mats[0][:, :n_in].t().contiguous()]
    out += [m.t().contiguous() for m in mats[1:-1]]
    out.append(mats[-1][:n_out, :].t().contiguous())
    return out


def render_params_from_torch(sd: Mapping, cfg, device: DeviceLike = None) -> Params:
    """Renderer heads (src_3dff feature_fields.py:218-256) -> render params:
    the position and aggregation Linear + LayerNorm pairs, and the
    ``nerf_encoder`` / ``nerf_decoder`` tcnn networks (``cfg`` is the
    FieldsConfig with ``mlp_net_width`` and ``mlp_net_layers``)."""
    dev = resolve_device(device)
    d = cfg.mlp_net_width
    n_enc = cfg.mlp_net_layers // 2
    n_dec = cfg.mlp_net_layers - n_enc
    enc = tcnn_mlp_from_flat(sd["nerf_encoder.params"], d, d + 1, d, n_enc, dev)
    dec = tcnn_mlp_from_flat(sd["nerf_decoder.params"], d, d, d, n_dec, dev)
    pos = dense_from_torch(sd, "patch_to_nerf_position_embedding.0", dev)
    agg = dense_from_torch(sd, "aggregate_patch_to_nerf_encoder.0", dev)
    return {
        "pos_w": pos["w"], "pos_b": pos["b"],
        "pos_ln": ln_from_torch(sd, "patch_to_nerf_position_embedding.1", dev),
        "agg_w": agg["w"], "agg_b": agg["b"],
        "agg_ln": ln_from_torch(sd, "aggregate_patch_to_nerf_encoder.1", dev),
        "mlp": {"enc_hidden": enc[:-1], "enc_out": enc[-1],
                "dec_hidden": dec[:-1], "dec_out": dec[-1]},
    }


# --------------------------------------------------------------------------
# CLIP (OpenAI layout, clip/model.py; HF tower of LLaVA)
# --------------------------------------------------------------------------
def _patchify_weight(conv_w: torch.Tensor) -> torch.Tensor:
    """torch ``[W, 3, P, P]`` patch conv -> the ``[P*P*3, W]`` patchify
    matrix (per patch, (ps, ps, 3) flattened)."""
    W, _, P, _ = conv_w.shape
    return conv_w.permute(2, 3, 1, 0).reshape(P * P * 3, W).contiguous()


def _clip_block_from_torch(sd: Mapping, prefix: str, device: torch.device) -> Params:
    return {
        "attn": {
            "qkv": {"w": _tensor(sd[f"{prefix}.attn.in_proj_weight"], device).t().contiguous(),
                    "b": _tensor(sd[f"{prefix}.attn.in_proj_bias"], device)},
            "out": dense_from_torch(sd, f"{prefix}.attn.out_proj", device),
        },
        "ln1": ln_from_torch(sd, f"{prefix}.ln_1", device),
        "ln2": ln_from_torch(sd, f"{prefix}.ln_2", device),
        "fc1": dense_from_torch(sd, f"{prefix}.mlp.c_fc", device),
        "fc2": dense_from_torch(sd, f"{prefix}.mlp.c_proj", device),
    }


def clip_params_from_torch(sd: Mapping, vision_layers: int, text_layers: int,
                           device: DeviceLike = None) -> Params:
    """OpenAI CLIP state dict -> both towers."""
    dev = resolve_device(device)
    return {
        "visual": {
            "conv1_w": _patchify_weight(_tensor(sd["visual.conv1.weight"], dev)),
            "class_embedding": _tensor(sd["visual.class_embedding"], dev),
            "positional_embedding": _tensor(sd["visual.positional_embedding"], dev),
            "ln_pre": ln_from_torch(sd, "visual.ln_pre", dev),
            "transformer": {"blocks": [
                _clip_block_from_torch(sd, f"visual.transformer.resblocks.{i}", dev)
                for i in range(vision_layers)]},
            "ln_post": ln_from_torch(sd, "visual.ln_post", dev),
            "proj": _tensor(sd["visual.proj"], dev),
        },
        "text": {
            "token_embedding": _tensor(sd["token_embedding.weight"], dev),
            "positional_embedding": _tensor(sd["positional_embedding"], dev),
            "transformer": {"blocks": [
                _clip_block_from_torch(sd, f"transformer.resblocks.{i}", dev)
                for i in range(text_layers)]},
            "ln_final": ln_from_torch(sd, "ln_final", dev),
            "projection": _tensor(sd["text_projection"], dev),
        },
    }


def clip_vision_from_hf(sd: Mapping, num_layers: int, device: DeviceLike = None) -> Params:
    """HF ``CLIPVisionModel`` (the LLaVA ``vision_tower``) -> the port's
    CLIP ``visual`` tree.

    The HF tower has separate q/k/v projections and ``pre_layrnorm``
    [sic].  LLaVA reads the hidden states at ``vision_feature_layer=-2``, so
    ``ln_post`` and ``proj`` are identity fills that the hidden-layer path
    never reaches."""
    dev = resolve_device(device)

    def g(k):
        for cand in (k, f"vision_tower.{k}", f"model.vision_tower.{k}",
                     f"vision_tower.vision_model.{k}", f"model.vision_tower.vision_model.{k}",
                     f"vision_model.{k}"):
            if cand in sd:
                return _tensor(sd[cand], dev)
        raise KeyError(k)

    def dense(prefix):
        return {"w": g(f"{prefix}.weight").t().contiguous(), "b": g(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    def block(i):
        p = f"encoder.layers.{i}"
        proj = ("q_proj", "k_proj", "v_proj")
        return {
            "attn": {
                "qkv": {"w": torch.cat([g(f"{p}.self_attn.{n}.weight") for n in proj]).t()
                        .contiguous(),
                        "b": torch.cat([g(f"{p}.self_attn.{n}.bias") for n in proj])},
                "out": dense(f"{p}.self_attn.out_proj"),
            },
            "ln1": ln(f"{p}.layer_norm1"),
            "ln2": ln(f"{p}.layer_norm2"),
            "fc1": dense(f"{p}.mlp.fc1"),
            "fc2": dense(f"{p}.mlp.fc2"),
        }

    conv_w = g("embeddings.patch_embedding.weight")            # [W, 3, P, P], no bias
    W = conv_w.shape[0]
    return {
        "conv1_w": _patchify_weight(conv_w),
        "class_embedding": g("embeddings.class_embedding").reshape(-1),
        "positional_embedding": g("embeddings.position_embedding.weight"),
        "ln_pre": ln("pre_layrnorm"),
        "transformer": {"blocks": [block(i) for i in range(num_layers)]},
        "ln_post": {"scale": torch.ones(W, device=dev), "bias": torch.zeros(W, device=dev)},
        "proj": torch.eye(W, device=dev),
    }


# --------------------------------------------------------------------------
# Phi-3 / LLaVA (HF layout)
# --------------------------------------------------------------------------
def phi3_params_from_torch(sd: Mapping, num_layers: int, dtype=torch.bfloat16,
                           device: DeviceLike = None) -> Params:
    """HF ``Phi3ForCausalLM`` weights, bare or inside LLaVA, -> Phi-3 params:
    matrices transposed to ``[in, out]`` in ``dtype``, norms in float32.
    A fused ``qkv_proj`` is taken as it is, else ``q/k/v_proj`` are
    concatenated.  Each matrix is cast on ``device`` from the source dtype."""
    dev = resolve_device(device)

    def raw(k):
        # bare Phi3ForCausalLM, legacy llava ("language_model.model."), and
        # transformers>=4.52 llava ("model.language_model." with the inner
        # "model." dropped) key layouts
        stripped = k[len("model."):] if k.startswith("model.") else k
        for cand in (k, f"language_model.{k}", f"model.{k}", f"language_model.model.{k}",
                     f"model.language_model.{stripped}",
                     f"language_model.{stripped}" if stripped != k else k):
            if cand in sd:
                return sd[cand]
        raise KeyError(k)

    def mat(*keys):
        return torch.cat([_tensor(raw(k), dev, dtype) for k in keys]).t().contiguous()

    def norm(k):
        return _tensor(raw(k), dev)

    layers = []
    for i in range(num_layers):
        p = f"model.layers.{i}"
        try:
            qkv = mat(f"{p}.self_attn.qkv_proj.weight")
        except KeyError:
            qkv = mat(*(f"{p}.self_attn.{n}_proj.weight" for n in "qkv"))
        layers.append({
            "input_ln": norm(f"{p}.input_layernorm.weight"),
            "qkv": qkv,
            "o": mat(f"{p}.self_attn.o_proj.weight"),
            "post_ln": norm(f"{p}.post_attention_layernorm.weight"),
            "gate_up": mat(f"{p}.mlp.gate_up_proj.weight"),
            "down": mat(f"{p}.mlp.down_proj.weight"),
        })
    return {
        "embed_tokens": _tensor(raw("model.embed_tokens.weight"), dev, dtype),
        "layers": layers,
        "final_ln": norm("model.norm.weight"),
        "lm_head": mat("lm_head.weight"),
    }


def llava_projector_from_torch(sd: Mapping, device: DeviceLike = None) -> Params:
    """The LLaVA projector: at the top level before transformers 4.52,
    under ``model.`` from 4.52."""
    prefix = ("multi_modal_projector" if "multi_modal_projector.linear_1.weight" in sd
              else "model.multi_modal_projector")
    return {"fc1": dense_from_torch(sd, f"{prefix}.linear_1", device),
            "fc2": dense_from_torch(sd, f"{prefix}.linear_2", device)}


# the five projector MLPs of the VLN policy: the port's names, the reference
# module names under "net." (Policy_Dynam3D_VLN.py:83-111)
PROJECTORS = (("patch_pos_emb", "patch_position_embedding"),
              ("inst_pos_emb", "instance_position_embedding"),
              ("zone_pos_emb", "zone_position_embedding"),
              ("inst_proj", "instance_projector"),
              ("zone_proj", "zone_projector"))


# --------------------------------------------------------------------------
# Waypoint BERT (TRM_net.py + waypoint_bert.py)
# --------------------------------------------------------------------------
def waypoint_params_from_torch(sd: Mapping, n_layers: int = 2,
                               device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    layers = []
    for i in range(n_layers):
        p = f"waypoint_TRM.bert.encoder.layer.{i}"
        names = ("query", "key", "value")
        layers.append({
            "attn": {
                "qkv": {"w": torch.cat([_tensor(sd[f"{p}.attention.self.{n}.weight"], dev)
                                        for n in names]).t().contiguous(),
                        "b": torch.cat([_tensor(sd[f"{p}.attention.self.{n}.bias"], dev)
                                        for n in names])},
                "out": dense_from_torch(sd, f"{p}.attention.output.dense", dev),
            },
            "ln1": ln_from_torch(sd, f"{p}.attention.output.LayerNorm", dev),
            "ff1": dense_from_torch(sd, f"{p}.intermediate.dense", dev),
            "ff2": dense_from_torch(sd, f"{p}.output.dense", dev),
            "ln2": ln_from_torch(sd, f"{p}.output.LayerNorm", dev),
        })
    return {
        "visual_fc_depth": dense_from_torch(sd, "visual_fc_depth.1", dev),
        "bert_layers": layers,
        "cls_fc1": dense_from_torch(sd, "vis_classifier.0", dev),
        "cls_fc2": dense_from_torch(sd, "vis_classifier.2", dev),
    }


# --------------------------------------------------------------------------
# YOLOv8-seg / FastSAM (ultralytics layout, BN folded)
# --------------------------------------------------------------------------
def conv_bn_from_torch(sd: Mapping, prefix: str, eps: float = 1e-3,
                       device: DeviceLike = None) -> Params:
    """ultralytics ``Conv`` = Conv2d(bias=False) + BatchNorm2d -> the folded
    OIHW weight and bias.

    The square root of ``var + eps`` is taken in float64 and rounded once to
    float32, which is the correctly rounded float32 root (``np.sqrt``'s);
    torch's float32 ``sqrt`` on the CPU is not, and would move folded
    weights by an ulp.  The rest runs in float32 in the reference's order."""
    dev = resolve_device(device)
    w = _tensor(sd[f"{prefix}.conv.weight"], dev)             # [O, I, kh, kw]
    gamma, beta, mean, var = (_tensor(sd[f"{prefix}.bn.{k}"], dev)
                              for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / (var + eps).double().sqrt().float()
    return {"w": w * scale[:, None, None, None], "b": beta - mean * scale}


def plain_conv_from_torch(sd: Mapping, prefix: str, device: DeviceLike = None) -> Params:
    """Bare Conv2d (the detect head's output convolutions: bias, no BN)."""
    dev = resolve_device(device)
    w = _tensor(sd[f"{prefix}.weight"], dev)
    b = sd.get(f"{prefix}.bias")
    return {"w": w, "b": torch.zeros(w.shape[0], device=dev) if b is None else _tensor(b, dev)}


def _c2f_from_torch(sd: Mapping, prefix: str, n: int, device: torch.device) -> Params:
    return {
        "cv1": conv_bn_from_torch(sd, f"{prefix}.cv1", device=device),
        "m": [{"cv1": conv_bn_from_torch(sd, f"{prefix}.m.{i}.cv1", device=device),
               "cv2": conv_bn_from_torch(sd, f"{prefix}.m.{i}.cv2", device=device)}
              for i in range(n)],
        "cv2": conv_bn_from_torch(sd, f"{prefix}.cv2", device=device),
    }


def yolov8_params_from_torch(sd: Mapping, depth_n=(3, 6, 6, 3),
                             device: DeviceLike = None) -> Params:
    """FastSAM-x state dict (``model.model.N`` ultralytics indexing) -> the
    YOLOv8-seg tree.  Indices of the yolov8-seg yaml: 0 stem, 1 down1, 2
    c2f1, 3 down2, 4 c2f2, 5 down3, 6 c2f3, 7 down4, 8 c2f4, 9 sppf,
    12/15/18/21 neck c2fs, 16/19 pan convs, 22 Segment head."""
    dev = resolve_device(device)
    n1, n2, n3, n4 = depth_n
    m = "model.model"

    def cbn(prefix):
        return conv_bn_from_torch(sd, prefix, device=dev)

    p: Params = {
        "stem": cbn(f"{m}.0"),
        "down1": cbn(f"{m}.1"),
        "c2f1": _c2f_from_torch(sd, f"{m}.2", n1, dev),
        "down2": cbn(f"{m}.3"),
        "c2f2": _c2f_from_torch(sd, f"{m}.4", n2, dev),
        "down3": cbn(f"{m}.5"),
        "c2f3": _c2f_from_torch(sd, f"{m}.6", n3, dev),
        "down4": cbn(f"{m}.7"),
        "c2f4": _c2f_from_torch(sd, f"{m}.8", n4, dev),
        "sppf": {"cv1": cbn(f"{m}.9.cv1"), "cv2": cbn(f"{m}.9.cv2")},
        "neck1": _c2f_from_torch(sd, f"{m}.12", n1, dev),
        "neck2": _c2f_from_torch(sd, f"{m}.15", n1, dev),
        "pan1": cbn(f"{m}.16"),
        "neck3": _c2f_from_torch(sd, f"{m}.18", n1, dev),
        "pan2": cbn(f"{m}.19"),
        "neck4": _c2f_from_torch(sd, f"{m}.21", n1, dev),
        "proto": {cv: cbn(f"{m}.22.proto.{cv}") for cv in ("cv1", "cv2", "cv3")},
        "det": [],
    }
    for i in range(3):
        p["det"].append({
            "box0": cbn(f"{m}.22.cv2.{i}.0"),
            "box1": cbn(f"{m}.22.cv2.{i}.1"),
            "box2": plain_conv_from_torch(sd, f"{m}.22.cv2.{i}.2", dev),
            "cls0": cbn(f"{m}.22.cv3.{i}.0"),
            "cls1": cbn(f"{m}.22.cv3.{i}.1"),
            "cls2": plain_conv_from_torch(sd, f"{m}.22.cv3.{i}.2", dev),
            "m0": cbn(f"{m}.22.cv4.{i}.0"),
            "m1": cbn(f"{m}.22.cv4.{i}.1"),
            "m2": plain_conv_from_torch(sd, f"{m}.22.cv4.{i}.2", dev),
        })
    return p


# --------------------------------------------------------------------------
# DD-PPO depth ResNet-50 (habitat gibson-2plus checkpoint)
# --------------------------------------------------------------------------
def depth_resnet_from_torch(sd: Mapping, device: DeviceLike = None) -> Params:
    """gibson-2plus-resnet50.pth visual-encoder weights (after
    ``strip_prefix(..., "actor_critic.net.visual_encoder.")``, as
    resnet_encoders.py:40-52 does) -> depth-ResNet params, OIHW."""
    dev = resolve_device(device)

    def conv(prefix):
        return {"w": _tensor(sd[f"{prefix}.weight"], dev)}

    def gn(prefix):
        return {"scale": _tensor(sd[f"{prefix}.weight"], dev),
                "bias": _tensor(sd[f"{prefix}.bias"], dev)}

    stages = []
    for si, nb in enumerate((3, 4, 6, 3)):
        stage = []
        for bi in range(nb):
            b = f"backbone.layer{si + 1}.{bi}"
            blk = {"conv1": conv(f"{b}.convs.0"), "gn1": gn(f"{b}.convs.1"),
                   "conv2": conv(f"{b}.convs.3"), "gn2": gn(f"{b}.convs.4"),
                   "conv3": conv(f"{b}.convs.6"), "gn3": gn(f"{b}.convs.7")}
            if bi == 0:
                blk["down_conv"] = conv(f"{b}.downsample.0")
                blk["down_gn"] = gn(f"{b}.downsample.1")
            stage.append(blk)
        stages.append(stage)
    return {
        "stem_conv": conv("backbone.conv1.0"),
        "stem_gn": gn("backbone.conv1.1"),
        "stages": stages,
        "compress_conv": conv("compression.0"),
        "compress_gn": gn("compression.1"),
    }
