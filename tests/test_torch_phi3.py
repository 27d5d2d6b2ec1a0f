"""Port parity of the Phi-3 decoder: ``quantize_phi3(bits=4)`` identical
q values, scales and packed bytes; the W8A8 prefill logits; the n-gram
draft; and greedy / speculative decode emitting the SAME token ids as the
JAX package on a tiny model — dense, and int4-quantized (repacked with
64-row groups and 64-wide blocks so the tiny widths carry no padding).

On the JAX side decode runs its CPU oracle (``decode_forward`` over
dequantized weights); on the port it runs ``decode_layer_ring``'s plain
versions.  Tolerance for the prefill logits: 2e-2 (W8A8 activations are
quantized from bf16 activations that differ in the last bit); token ids:
exact."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import Dynam3DConfig, LLaVAConfig
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.models.vlm import phi3 as tphi3
from tests.test_spec_decode import _cfg, _prompt, _quantized_eligible
from tests.torch_parity import np32, port_config, to_torch


def _tcfg(cfg):
    return port_config(Dynam3DConfig(llava=LLaVAConfig(phi3=cfg))).llava.phi3


def _torch_prompt(embeds, valid):
    return torch.from_numpy(np32(embeds)).to(torch.bfloat16), torch.from_numpy(np.array(valid))


def test_quantize_phi3_bits4_identical():
    cfg = _cfg()
    jp = jphi3.init_phi3_params(jax.random.PRNGKey(0), cfg)
    tq = tphi3.quantize_phi3(to_torch(jp), bits=4)
    jq = jphi3.quantize_phi3(jp, bits=4)
    for name in ("qkv", "o", "gate_up", "down"):
        jw, tw = jq["layers"][1][name], tq["layers"][1][name]
        np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
        np.testing.assert_array_equal(tw["s"].numpy(), np.asarray(jw["s"]))
        np.testing.assert_array_equal(tw["q4"].q4.numpy(), np.asarray(jw["q4"].q4))
        np.testing.assert_array_equal(tw["q4"].s_lo.numpy(), np.asarray(jw["q4"].s_lo))
        np.testing.assert_array_equal(tw["q4"].s_hi.numpy(), np.asarray(jw["q4"].s_hi))
    np.testing.assert_array_equal(tq["lm_head"]["q4"].q4.numpy(),
                                  np.asarray(jq["lm_head"]["q4"].q4))


def test_w8a8_prefill_logits():
    cfg = _cfg()
    qp = _quantized_eligible(cfg, seed=1)
    embeds, valid = _prompt(cfg, 1)
    total = 40
    cache = jphi3.init_cache(cfg, 1, total, dtype=jnp.bfloat16)
    pos = jnp.maximum(jnp.cumsum(valid.astype(jnp.int32), 1) - 1, 0)
    last = jphi3._last_valid_idx(valid)
    jl, _ = jphi3.forward(qp, cfg, embeds, pos, cache, 0, jphi3.prefill_mask(valid, total),
                          lm_at=last)
    te, tv = _torch_prompt(embeds, valid)
    tcfg = _tcfg(cfg)
    tc = tphi3.init_cache(tcfg, 1, total, dtype=torch.bfloat16, device="cpu")
    tl, _ = tphi3.forward(to_torch(qp), tcfg, te, torch.from_numpy(np.asarray(pos)), tc, 0,
                          tphi3.prefill_mask(tv, total), lm_at=tphi3._last_valid_idx(tv))
    assert int(tphi3._last_valid_idx(tv)[0]) == int(last[0])
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=2e-2, atol=2e-2)


def test_ngram_draft_matches():
    rng = np.random.default_rng(0)
    Lh = 24
    for k in (2, 5, 8):
        jdraft = jax.jit(jphi3._ngram_draft, static_argnums=6)
        for _ in range(20):
            hist = rng.integers(-1, 4, Lh)
            n = int(rng.integers(2, Lh + 1))
            p3, p2, p1, last = (int(v) for v in rng.integers(-1, 4, 4))
            j = jdraft(jnp.asarray(hist, jnp.int32), n, p3, p2, p1, last, k)
            t = tphi3._ngram_draft(hist.astype(np.int64), n, p3, p2, p1, last, k)
            np.testing.assert_array_equal(t, np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_spec_decode_ids_identical_int4(seed):
    cfg = _cfg()
    qp = _quantized_eligible(cfg, seed=seed)
    tp = to_torch(qp)
    embeds, valid = _prompt(cfg, seed)
    n = 12
    lookup = np.full((n + 8,), -1, np.int32)
    ref = np.asarray(jphi3.greedy_decode(qp, cfg, embeds, valid, n, stop_token=-1))
    lookup[3: 3 + n] = ref[0]          # plant the continuation: drafts hit
    jout = np.asarray(jphi3.greedy_decode_spec(qp, cfg, embeds, valid, n, stop_token=-1,
                                               lookup_ids=jnp.asarray(lookup)))
    te, tv = _torch_prompt(embeds, valid)
    stats = {}
    tout = tphi3.greedy_decode_spec(tp, _tcfg(cfg), te, tv, n, stop_token=-1,
                                    lookup_ids=torch.from_numpy(lookup), stats=stats)
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tout.numpy(), ref)
    assert stats["tokens"] == n and stats["passes"] < n
    # no drafts at all: every pass is the plain one-token step
    tout2 = tphi3.greedy_decode_spec(tp, _tcfg(cfg), te, tv, n, stop_token=-1)
    np.testing.assert_array_equal(tout2.numpy(), ref)


def test_greedy_and_spec_dense_with_stop():
    cfg = _cfg()
    jp = jphi3.init_phi3_params(jax.random.PRNGKey(5), cfg)
    tp = to_torch(jp)
    embeds, valid = _prompt(cfg, 5)
    te, tv = _torch_prompt(embeds, valid)
    n = 12
    free = np.asarray(jphi3.greedy_decode(jp, cfg, embeds, valid, n, stop_token=-1))
    stop = int(free[0, 4])
    for fn_j, fn_t in ((jphi3.greedy_decode, tphi3.greedy_decode),
                       (jphi3.greedy_decode_spec, tphi3.greedy_decode_spec)):
        for st in (-1, stop):
            ref = np.asarray(fn_j(jp, cfg, embeds, valid, n, stop_token=st))
            got = fn_t(tp, _tcfg(cfg), te, tv, n, stop_token=st)
            np.testing.assert_array_equal(got.numpy(), ref)
