"""Port parity of kernel H (``decode_attn_layer``) and of the split decode
route it serves, against the JAX package:

* the plain version against the TPU kernel run in interpret mode, at write
  slots 70 and 600 with mask holes (D=256, 4 heads of 64, dblk=nblk=128,
  Tmax=1024);
* the split ``_decode_forward_split`` (kernel H then kernel G per layer,
  ``DYNAM3D_FUSED_RING=0``) against the JAX one with its ring flag off and
  its attention kernel in interpret mode: logits and the new cache rows.

Tolerances, with the largest error measured on the CPU: kernel H's output
and k_new/v_new 3e-2 absolute at magnitudes ~2 (the TPU kernel rounds the
k*q products and the probabilities to bf16, the port keeps f32 as kernel B
does; bf16 outputs; measured 1.6e-2); split-route logits 5e-2 and cache
rows 3e-2 (the JAX package's own bound for its fused routes against the
same oracle; measured 3.0e-3 and 2.0e-3)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu import flags as jflags
from dynam3d_tpu.config import Dynam3DConfig, LLaVAConfig, Phi3Config
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_tpu.ops import pallas_decode as jdecode
from dynam3d_tpu.ops.pallas_int4 import pack_int4 as jpack
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.ops import decode as tdecode
from dynam3d_torch.ops import int4 as tint4
from tests.torch_parity import np32, port_config, to_torch

D, HEADS, HD, BLK = 256, 4, 64, 128


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("pos,holes", [(70, ((10, 20),)), (600, ((10, 20), (515, 530)))])
def test_attn_layer_plain_matches_pallas_interpret(pos, holes):
    rng = np.random.default_rng(pos)
    L, li, tmax = 2, 1, 1024
    wqkv = rng.normal(scale=0.05, size=(D, 3 * D)).astype(np.float32)
    wo = rng.normal(scale=0.05, size=(D, D)).astype(np.float32)
    jq, jo = (jpack(jnp.asarray(w), dblk=BLK, nblk=BLK) for w in (wqkv, wo))
    tq, to = (tint4.pack_int4(torch.from_numpy(w), dblk=BLK, nblk=BLK) for w in (wqkv, wo))
    x = np32(jnp.asarray(rng.normal(size=(1, 1, D)), jnp.bfloat16))
    ck = np32(jnp.asarray(rng.normal(size=(L, 1, tmax, D)), jnp.bfloat16))
    cv = np32(jnp.asarray(rng.normal(size=(L, 1, tmax, D)), jnp.bfloat16))
    ln = (1.0 + 0.2 * rng.normal(size=D)).astype(np.float32)
    mask = np.arange(tmax) < pos
    for a, b in holes:
        mask[a:b] = False
    half = HD // 2
    ang = (pos - 7) * 1e4 ** (-np.arange(half, dtype=np.float32) / half)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    ref = jdecode.decode_attn_layer(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ln), jq, jo, jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16), li, pos, jnp.asarray(mask), jnp.asarray(cos),
        jnp.asarray(sin), eps=1e-5, heads=HEADS, hd=HD, interpret=True)
    got = tdecode.decode_attn_layer(
        _bf(x), torch.from_numpy(ln), tq, to, _bf(ck), _bf(cv), li, pos, torch.from_numpy(mask),
        torch.from_numpy(cos), torch.from_numpy(sin), eps=1e-5, heads=HEADS, hd=HD)
    assert got[0].shape == (1, 1, D) and got[1].shape == got[2].shape == (1, D)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np32(g).reshape(np32(r).shape), np32(r), rtol=0, atol=3e-2)


def _split_cfg():
    return Phi3Config(vocab_size=512, hidden_size=D, intermediate_size=512, num_layers=2,
                      num_heads=HEADS, num_kv_heads=HEADS, head_dim=HD, pad_token_id=260,
                      end_token_id=257)


def test_split_route_matches_reference(monkeypatch):
    cfg = _split_cfg()
    params = jphi3.init_phi3_params(jax.random.PRNGKey(0), cfg)
    qparams = jphi3.quantize_phi3(params, bits=4)
    for lp, qlp in zip(params["layers"], qparams["layers"]):
        for name in ("qkv", "o", "gate_up", "down"):
            qlp[name]["q4"] = jpack(lp[name].astype(jnp.float32), dblk=BLK, nblk=BLK)
    monkeypatch.setattr(jdecode, "decode_attn_layer",
                        functools.partial(jdecode.decode_attn_layer.__wrapped__, interpret=True))
    monkeypatch.setattr(jflags, "FUSED_DECODE_RING", False)
    monkeypatch.setenv("DYNAM3D_FUSED_RING", "0")
    tcfg = port_config(Dynam3DConfig(llava=LLaVAConfig(phi3=cfg))).llava.phi3
    tparams = to_torch(qparams)
    assert tphi3.decode_route(tparams, tcfg, 1) == "split"

    rng = np.random.default_rng(5)
    T, total = 40, 512
    embeds = jnp.asarray(rng.normal(size=(1, T, D)), jnp.bfloat16)
    av = np.ones((1, T), bool)
    av[0, 30:34] = False
    cache = jphi3.init_cache(cfg, 1, total, dtype=jnp.bfloat16)
    positions = jnp.maximum(jnp.cumsum(jnp.asarray(av, jnp.int32), 1) - 1, 0)
    _, cache = jphi3.forward(qparams, cfg, embeds, positions, cache, 0,
                             jphi3.prefill_mask(jnp.asarray(av), total))
    valid = np.zeros((1, total), bool)
    valid[0, :T] = av[0]
    valid[0, T] = True
    e = rng.normal(size=(1, 1, D)).astype(np.float32)
    pos = valid.sum(1, keepdims=True) - 1
    L = cfg.num_layers
    flat = jphi3.KVCache(cache.k.reshape(L, 1, total, D), cache.v.reshape(L, 1, total, D))
    lg_ref, c_ref = jphi3._decode_forward_fused(qparams, cfg, jnp.asarray(e, jnp.bfloat16),
                                                jnp.asarray(pos), flat, T, jnp.asarray(valid))
    tflat = tphi3.KVCache(_bf(np32(flat.k)), _bf(np32(flat.v)))
    lg, c = tphi3._decode_forward_split(tparams, tcfg, _bf(e), torch.from_numpy(pos), tflat, T,
                                        torch.from_numpy(valid))
    np.testing.assert_allclose(np32(lg), np32(lg_ref), rtol=5e-2, atol=5e-2)
    assert int(np32(lg).argmax()) == int(np32(lg_ref).argmax())
    for got, ref in ((c.k, c_ref.k), (c.v, c_ref.v)):
        np.testing.assert_allclose(np32(got[:, 0, T]), np32(ref[:, 0, T]), rtol=3e-2, atol=3e-2)
