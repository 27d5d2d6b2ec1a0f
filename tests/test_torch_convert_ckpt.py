"""The port's reference-weight converters against the JAX package's on the
same state dicts: ``dynam3d_torch.tools.convert_reference_ckpt.convert``
vs ``tools/convert_reference_ckpt.py::convert`` on each of the eight asset
routes (the trainer checkpoint also under DDP's ``net.module.``, LLaVA in
the transformers >= 4.52 and the legacy key layouts and from a bf16
source), Phi-3 in its other layouts, the BatchNorm fold, ``strip_prefix``
and the tinycudann flat layout; then the port's Phi-3 on the conversion of
a random HF ``Phi3ForCausalLM`` against that model's logits.

The state dicts are the JAX package's ``synth_all`` of a tiny tree (the
port's ``init_policy_params`` laid out as the reference's).  Both
converters start from the same tree for the parts a route does not
convert, so whole trees compare: the port's equals ``params_from_jax`` of
the reference's in every dtype and value (max abs diff 0)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import convert_reference_ckpt as jtool  # noqa: E402

from dynam3d_tpu.models import policy as jpolicy  # noqa: E402
from dynam3d_tpu.models.render import nerf as jnerf  # noqa: E402
from dynam3d_tpu.runtime import checkpoint as jck  # noqa: E402
from dynam3d_torch.convert import conv_params_from_jax, params_from_jax  # noqa: E402
from dynam3d_torch.models import policy as tpolicy  # noqa: E402
from dynam3d_torch.models.render import nerf as tnerf  # noqa: E402
from dynam3d_torch.runtime import checkpoint as tck  # noqa: E402
from dynam3d_torch.tools import convert_reference_ckpt as ttool  # noqa: E402
from tests.torch_parity import assert_trees_identical, runway_world  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_sd(sd, dtype=None):
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


@pytest.fixture(scope="module")
def world():
    return runway_world()


def _legacy_llava(sd):
    """transformers < 4.52 names: tower and projector at the top level, the
    LM under ``language_model.``."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model.vision_tower.") or k.startswith("model.multi_modal_projector."):
            k = k[len("model."):]
        elif k.startswith("model.language_model."):
            k = "language_model.model." + k[len("model.language_model."):]
        elif k == "lm_head.weight":
            k = "language_model.lm_head.weight"
        out[k] = v
    return out


ROUTES = {
    "dynam3d": lambda s: ({"dynam3d": s["dynam3d"]}, None),
    "pretrain": lambda s: ({"pretrain": s["pretrain"]}, None),
    "vln": lambda s: ({"vln": s["vln_ckpt"]}, None),
    "vln_ddp": lambda s: ({"vln": {f"net.module.{k[len('net.'):]}": v
                                   for k, v in s["vln_ckpt"].items()}}, None),
    "llava": lambda s: ({"llava": s["llava"]}, None),
    "llava_legacy": lambda s: ({"llava": _legacy_llava(s["llava"])}, None),
    "llava_bf16_source": lambda s: ({"llava": s["llava"]}, torch.bfloat16),
    "clip": lambda s: ({"clip": s["clip"]}, None),
    "fastsam": lambda s: ({"fastsam": s["fastsam"]}, None),
    "waypoint": lambda s: ({"waypoint": s["waypoint"]}, None),
    "ddppo": lambda s: ({"ddppo": s["ddppo"]}, None),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_convert_route_equals_the_reference(world, route, monkeypatch):
    """Both ``convert``s over one asset: the same report, and the port's
    tree (and renderer, waypoint, depth extras) equal to ``params_from_jax``
    of the reference's, dtype for dtype, bit for bit."""
    jcfg, tcfg, _, ref, sds = world
    paths, src_dtype = ROUTES[route](sds)
    if src_dtype is not None:
        # a bf16 checkpoint, as the HF asset ships: the reference widens it
        # on the host, the port casts on the device; the same leaves result
        paths = {k: {n: torch.from_numpy(np.array(v)).to(src_dtype) for n, v in sd.items()}
                 for k, sd in paths.items()}
        jpaths = paths
    else:
        jpaths = paths
        paths = {k: _torch_sd(sd) for k, sd in paths.items()}
    monkeypatch.setattr(jpolicy, "init_policy_params", lambda *a, **k: dict(ref["params"]))
    monkeypatch.setattr(jnerf, "init_render_params", lambda *a, **k: ref["render"])
    monkeypatch.setattr(tpolicy, "init_policy_params",
                        lambda *a, **k: params_from_jax(ref["params"], "cpu"))
    monkeypatch.setattr(tnerf, "init_render_params",
                        lambda *a, **k: params_from_jax(ref["render"], "cpu"))

    jp, jextras, jreport = jtool.convert(jcfg, jpaths)
    tp, textras, treport = ttool.convert(tcfg, paths, device="cpu")
    assert treport == jreport and treport
    assert_trees_identical(tp, params_from_jax(_np_tree(jp), "cpu"))
    assert sorted(textras) == sorted(jextras)
    for name, sub in jextras.items():
        conv = conv_params_from_jax if name == "depth_enc" else params_from_jax
        assert_trees_identical(textras[name], conv(_np_tree(sub), "cpu"), name)
    if route == "llava_bf16_source":
        assert tp["llava"]["projector"]["fc1"]["w"].dtype == torch.float32
        assert tp["llava"]["phi3"]["layers"][0]["qkv"].dtype == torch.bfloat16
        assert tp["llava"]["phi3"]["final_ln"].dtype == torch.float32


def _bare_phi3(sd):
    lm = "model.language_model."
    out = {f"model.{k[len(lm):]}": v for k, v in sd.items() if k.startswith(lm)}
    out["lm_head.weight"] = sd["lm_head.weight"]
    return out


def _split_qkv(sd):
    out = {}
    for k, v in sd.items():
        if k.endswith("self_attn.qkv_proj.weight"):
            q, kk, vv = np.split(v, 3, axis=0)
            for n, part in zip("qkv", (q, kk, vv)):
                out[k.replace("qkv_proj", f"{n}_proj")] = part
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("layout,dtype", [("bare", "bf16"), ("split_qkv", "bf16"),
                                          ("bare", "f32")])
def test_phi3_layouts_equal_the_reference(world, layout, dtype):
    """A bare ``Phi3ForCausalLM`` and split ``q/k/v_proj`` weights, into
    bf16 and float32 trees."""
    jcfg, _, _, _, sds = world
    sd = _bare_phi3(sds["llava"])
    if layout == "split_qkv":
        sd = _split_qkv(sd)
    jdt, tdt = {"bf16": (jax.numpy.bfloat16, torch.bfloat16),
                "f32": (jax.numpy.float32, torch.float32)}[dtype]
    n = jcfg.llava.phi3.num_layers
    want = params_from_jax(_np_tree(jck.phi3_params_from_torch(sd, n, dtype=jdt)), "cpu")
    got = tck.phi3_params_from_torch(_torch_sd(sd), n, dtype=tdt, device="cpu")
    assert_trees_identical(got, want)


def test_bn_fold_equals_the_reference_and_needs_the_f64_root():
    """Random BatchNorm statistics: the port's fold equals the reference's
    bit for bit; folding with torch's float32 ``sqrt`` on the CPU would not
    (it is not correctly rounded there)."""
    rng = np.random.default_rng(0)
    O = 20000
    sd = {"c.conv.weight": rng.normal(size=(O, 2, 1, 1)).astype(np.float32),
          "c.bn.weight": rng.uniform(0.5, 1.5, O).astype(np.float32),
          "c.bn.bias": rng.uniform(-0.5, 0.5, O).astype(np.float32),
          "c.bn.running_mean": rng.uniform(-1, 1, O).astype(np.float32),
          "c.bn.running_var": rng.uniform(0.5, 2.0, O).astype(np.float32)}
    want = conv_params_from_jax(_np_tree(jck.conv_bn_from_torch(sd, "c")), "cpu")
    tsd = _torch_sd(sd)
    got = tck.conv_bn_from_torch(tsd, "c", device="cpu")
    assert_trees_identical(got, want)
    naive = tsd["c.bn.weight"] / (tsd["c.bn.running_var"] + 1e-3).sqrt()
    naive_b = tsd["c.bn.bias"] - tsd["c.bn.running_mean"] * naive
    assert int((naive_b != want["b"]).sum()) > 0


def test_strip_prefix_equals_the_reference():
    rng = np.random.default_rng(1)
    sd = {k: rng.normal(size=3).astype(np.float32) for k in (
        "module.net.feature_fields.a.weight", "net.feature_fields.b", "net.other.c",
        "module.module.net.feature_fields.d", "feature_fields.e")}
    want = jck.strip_prefix(sd, "net.feature_fields.")
    got = tck.strip_prefix(_torch_sd(sd), "net.feature_fields.")
    assert sorted(got) == sorted(want) == ["a.weight", "b"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_tcnn_flat_fp16_equals_the_reference():
    """A tinycudann fp16 vector (in 7 -> 16, out 9 -> 16 padded, 32
    neurons, 2 hidden layers) into float32 ``[in, out]`` matrices; a vector
    of the wrong size raises in both."""
    rng = np.random.default_rng(2)
    n = 32 * 16 + 32 * 32 + 16 * 32
    flat = rng.normal(size=n).astype(np.float16)
    want = jck.tcnn_mlp_from_flat(flat, 7, 9, 32, 2)
    got = tck.tcnn_mlp_from_flat(torch.from_numpy(flat), 7, 9, 32, 2, device="cpu")
    assert [tuple(g.shape) for g in got] == [(7, 32), (32, 32), (32, 9)]
    assert_trees_identical(got, params_from_jax(_np_tree(want), "cpu"))
    longer = np.concatenate([flat, flat[:1]])
    for fn, arg in ((jck.tcnn_mlp_from_flat, longer),
                    (lambda *a: tck.tcnn_mlp_from_flat(*a, device="cpu"),
                     torch.from_numpy(longer))):
        with pytest.raises(ValueError, match="tcnn flat params"):
            fn(arg, 7, 9, 32, 2)


def test_phi3_logits_match_hf_phi3():
    """The port's Phi-3 on ``phi3_params_from_torch`` of a random
    ``Phi3ForCausalLM`` (float32) gives its logits within rtol = atol =
    2e-3."""
    from transformers import Phi3Config as HFPhi3Config
    from transformers import Phi3ForCausalLM

    from dynam3d_torch.config import Phi3Config
    from dynam3d_torch.models.vlm import phi3
    from dynam3d_torch.runtime.checkpoint import phi3_params_from_torch

    D, H = 32, 4
    hf_cfg = HFPhi3Config(vocab_size=128, hidden_size=D, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=H, num_key_value_heads=H,
                          max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
                          attention_dropout=0.0, tie_word_embeddings=False, pad_token_id=0,
                          bos_token_id=1, eos_token_id=2)
    torch.manual_seed(0)
    model = Phi3ForCausalLM(hf_cfg).eval()
    cfg = Phi3Config(vocab_size=128, hidden_size=D, intermediate_size=64, num_layers=2,
                     num_heads=H, num_kv_heads=H, head_dim=D // H, pad_token_id=0,
                     end_token_id=1)
    params = phi3_params_from_torch(model.state_dict(), 2, dtype=torch.float32, device="cpu")
    ids = torch.randint(0, 128, (1, 10), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(ids).logits[0].numpy()
        valid = torch.ones(1, 10, dtype=torch.bool)
        pos = torch.clamp(torch.cumsum(valid.to(torch.int64), 1) - 1, min=0)
        cache = phi3.init_cache(cfg, 1, 10, dtype=torch.float32, device="cpu")
        logits, _ = phi3.forward(params, cfg, phi3.embed(params, ids), pos, cache, 0,
                                 phi3.prefill_mask(valid, 10))
    np.testing.assert_allclose(logits[0].numpy(), want, rtol=2e-3, atol=2e-3)
