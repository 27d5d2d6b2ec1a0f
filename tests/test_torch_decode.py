"""Port parity of the decode layer (``ops/decode.py::decode_layer_ring``,
plain versions of kernels A and B) against the JAX package's oracles, in
the three modes of the TPU kernel:

* shared_cache (speculative verify): the port's ``_verify_forward_fused``
  vs ``decode_forward`` with the row-causal mask, including a prompt whose
  draft rows cross the 512-row block boundary;
* plain (B rows, own caches): ``_decode_forward_fused`` vs
  ``decode_forward`` with per-row validity;
* group_size (B episodes x g drafts): a grouped pass over the port's layer
  vs the XLA branch of ``_verify_forward_grouped``;
* plus one small interpret-mode run of the Pallas ring kernel itself.

Tolerances: logits 5e-2 and new k/v 3e-2 (the JAX package's own bound for
its ring kernel against the same oracles: the oracle rounds q/k/v, the
o-projection output and the residual to bf16 where the ring keeps f32);
greedy argmax identical."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.ops.decode import decode_layer_ring
from tests.test_spec_decode import _cfg, _quantized_eligible
from tests.torch_parity import np32, port_config, to_torch

from dynam3d_tpu.config import Dynam3DConfig, LLaVAConfig


def _port_phi3_cfg(jcfg):
    return port_config(Dynam3DConfig(llava=LLaVAConfig(phi3=jcfg))).llava.phi3


def _prefilled(cfg, qparams, embeds, av, total):
    cache = jphi3.init_cache(cfg, embeds.shape[0], total, dtype=jnp.bfloat16)
    positions = jnp.maximum(jnp.cumsum(av.astype(jnp.int32), 1) - 1, 0)
    prefill = jax.jit(lambda p, e, pos, c, m: jphi3.forward(p, cfg, e, pos, c, 0, m)[1])
    cache = prefill(qparams, embeds, positions, cache, jphi3.prefill_mask(av, total))
    L, B = cfg.num_layers, embeds.shape[0]
    flat = tphi3.KVCache(
        torch.from_numpy(np32(cache.k)).to(torch.bfloat16).reshape(L, B, total, -1),
        torch.from_numpy(np32(cache.v)).to(torch.bfloat16).reshape(L, B, total, -1))
    return cache, flat


def _close(got, ref, tol):
    np.testing.assert_allclose(np32(got), np32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("T,total,k,holes", [
    (30, 512, 8, (10, 13)),
    (509, 1024, 4, (492, 502)),      # draft rows 509..512 cross the block edge
])
def test_shared_cache_verify_matches_oracle(T, total, k, holes):
    cfg = _cfg()
    tcfg = _port_phi3_cfg(cfg)
    qparams = _quantized_eligible(cfg, seed=k)
    tparams = to_torch(qparams)
    rng = np.random.default_rng(T + k)
    D = cfg.hidden_size
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(1, T, D)), jnp.bfloat16)
    av = np.ones((1, T), bool)
    av[0, holes[0]: holes[1]] = False
    av = jnp.asarray(av)
    cache, flat = _prefilled(cfg, qparams, embeds, av, total)
    valid = np.zeros((1, total), bool)
    valid[0, :T] = np.asarray(av)[0]
    n_pos0 = int(np.asarray(av).sum())
    e = rng.normal(scale=0.5, size=(1, k, D)).astype(np.float32)

    kk = jnp.arange(k)
    t_iota = jnp.arange(total)
    row_extra = (t_iota[None] >= T) & (t_iota[None] <= T + kk[:, None])
    m = jnp.asarray(valid)[:, None, :] | row_extra[None]
    decode = jax.jit(lambda p, x, pos, c, mm: jphi3.decode_forward(p, cfg, x, pos, c, T, mm))
    lg_ref, c_ref = decode(qparams, jnp.asarray(e, jnp.bfloat16), (n_pos0 + kk)[None], cache, m)
    lg, c = tphi3._verify_forward_fused(
        tparams, tcfg, torch.from_numpy(e).to(torch.bfloat16), n_pos0, flat, T,
        torch.from_numpy(valid))
    _close(lg, lg_ref, 5e-2)
    np.testing.assert_array_equal(np32(lg[0]).argmax(-1), np32(lg_ref[0]).argmax(-1))
    L = cfg.num_layers
    _close(c.k[:, 0, T: T + k], np32(c_ref.k[:, 0, T: T + k]).reshape(L, k, D), 3e-2)
    _close(c.v[:, 0, T: T + k], np32(c_ref.v[:, 0, T: T + k]).reshape(L, k, D), 3e-2)


def test_plain_rows_match_oracle():
    cfg = _cfg()
    tcfg = _port_phi3_cfg(cfg)
    qparams = _quantized_eligible(cfg, seed=21)
    tparams = to_torch(qparams)
    rng = np.random.default_rng(21)
    B, T, total, D = 2, 24, 512, cfg.hidden_size
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(B, T, D)), jnp.bfloat16)
    av = np.ones((B, T), bool)
    av[1, 18:] = False                       # rows of different lengths
    av = jnp.asarray(av)
    cache, flat = _prefilled(cfg, qparams, embeds, av, total)
    valid = np.zeros((B, total), bool)
    valid[:, :T] = np.asarray(av)
    valid[:, T] = True                       # the current slot
    pos = valid.sum(1, keepdims=True) - 1
    e = rng.normal(scale=0.5, size=(B, 1, D)).astype(np.float32)
    decode = jax.jit(lambda p, x, ps, c, mm: jphi3.decode_forward(p, cfg, x, ps, c, T, mm))
    lg_ref, c_ref = decode(qparams, jnp.asarray(e, jnp.bfloat16), jnp.asarray(pos), cache,
                           jnp.asarray(valid)[:, None, :])
    lg, c = tphi3._decode_forward_fused(tparams, tcfg, torch.from_numpy(e).to(torch.bfloat16),
                                        torch.from_numpy(pos), flat, T,
                                        torch.from_numpy(valid))
    _close(lg, lg_ref, 5e-2)
    np.testing.assert_array_equal(np32(lg).argmax(-1), np32(lg_ref).argmax(-1))
    _close(c.k[:, :, T], np32(c_ref.k[:, :, T]).reshape(cfg.num_layers, B, D), 3e-2)


def test_group_mode_matches_oracle():
    cfg = _cfg()
    tcfg = _port_phi3_cfg(cfg)
    qparams = _quantized_eligible(cfg, seed=13)
    tparams = to_torch(qparams)
    rng = np.random.default_rng(13)
    B, g, T, total, D = 2, 3, 24, 512, cfg.hidden_size
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(B, T, D)), jnp.bfloat16)
    av = np.ones((B, T), bool)
    av[0, 10:12] = False
    av[1, 18:24] = False
    av = jnp.asarray(av)
    cache, flat = _prefilled(cfg, qparams, embeds, av, total)
    valid = np.zeros((B, total), bool)
    valid[:, :T] = np.asarray(av)
    n_pos0 = np.asarray(av).sum(1)
    wslot = np.asarray([T, T + 2])
    e = rng.normal(scale=0.5, size=(B, g, D)).astype(np.float32)
    grouped = jax.jit(lambda p, x, n0, c, w, v: jphi3._verify_forward_grouped(
        p, cfg, x, n0, c, w, v, use_fused=False)[0])
    lg_ref = grouped(qparams, jnp.asarray(e, jnp.bfloat16), jnp.asarray(n_pos0), cache,
                     jnp.asarray(wslot), jnp.asarray(valid))

    # the grouped pass over the port's layer: rows (b, j) = episode b, draft j
    pos = torch.from_numpy((n_pos0[:, None] + np.arange(g)[None]).reshape(-1)).float()
    ang = pos[:, None] * tphi3._freqs(tcfg, "cpu")
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.from_numpy(np.repeat(valid, g, axis=0))
    posr = np.repeat(wslot, g).tolist()
    x = torch.from_numpy(e).to(torch.bfloat16).reshape(B * g, 1, D)
    for li, p in enumerate(tparams["layers"]):
        x, k_new, v_new = decode_layer_ring(
            x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
            p["gate_up"]["q4"], p["down"]["q4"], flat.k, flat.v, li, posr, mask, cos, sin,
            eps=tcfg.rms_eps, heads=tcfg.num_heads, hd=tcfg.head_dim, group_size=g)
        for b in range(B):
            flat.k[li, b, wslot[b]: wslot[b] + g] = k_new[b * g: (b + 1) * g]
            flat.v[li, b, wslot[b]: wslot[b] + g] = v_new[b * g: (b + 1) * g]
    x = tphi3.rms_norm(tparams["final_ln"], x.reshape(B, g, D), tcfg.rms_eps)
    lg = tphi3._lm_head(tparams, x)
    _close(lg, lg_ref, 5e-2)
    np.testing.assert_array_equal(np32(lg).argmax(-1), np32(lg_ref).argmax(-1))


def test_layer_matches_pallas_ring_in_interpret_mode():
    """One layer, plain B=1, against the TPU kernel run in interpret mode."""
    from dynam3d_tpu.ops.pallas_decode import decode_layer_ring as j_ring

    cfg = _cfg()
    qparams = _quantized_eligible(cfg, seed=2)
    tparams = to_torch(qparams)
    rng = np.random.default_rng(2)
    D, total, T = cfg.hidden_size, 512, 40
    ck = rng.normal(size=(1, 1, total, D)).astype(np.float32)
    cv = rng.normal(size=(1, 1, total, D)).astype(np.float32)
    x = rng.normal(scale=0.5, size=(1, 1, D)).astype(np.float32)
    mask = np.arange(total)[None] < T
    mask[0, 7:11] = False
    ang = np.float32(T - 4) * 10000.0 ** (-np.arange(16, dtype=np.float32) / 16)
    cos, sin = np.cos(ang)[None].astype(np.float32), np.sin(ang)[None].astype(np.float32)
    p, tp = qparams["layers"][0], tparams["layers"][0]
    ref = j_ring.__wrapped__(
        jnp.asarray(x, jnp.bfloat16), p["input_ln"], p["qkv"]["q4"], p["o"]["q4"],
        p["post_ln"], p["gate_up"]["q4"], p["down"]["q4"], jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16), 0, T, jnp.asarray(mask), jnp.asarray(cos),
        jnp.asarray(sin), eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim,
        interpret=True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = decode_layer_ring(
        bf(x), tp["input_ln"], tp["qkv"]["q4"], tp["o"]["q4"], tp["post_ln"],
        tp["gate_up"]["q4"], tp["down"]["q4"], bf(ck), bf(cv), 0, T,
        torch.from_numpy(mask), torch.from_numpy(cos), torch.from_numpy(sin),
        eps=cfg.rms_eps, heads=cfg.num_heads, hd=cfg.head_dim)
    for a, b in zip(got, ref):
        _close(a.reshape(np32(b).shape), b, 3e-2)
