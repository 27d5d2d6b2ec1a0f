"""The decode tools' parity against the JAX package, on the CPU, over one
tiny int4 Phi-3 (``tests/test_spec_decode.py``'s ring-eligible config and
packing, made once for the file):

* ``flags.spec_force_accept``: ``greedy_decode_spec`` (no lookup: every
  pass verifies its missing drafts all the same) at B = 1 and at B = 2
  gives the ids of the JAX functions
  under ``dynam3d_tpu.flags.SPEC_FORCE_ACCEPT``, exactly, every pass
  accepting all its rows;
* ``prof_decode_parts`` on the CPU: the unfused one-step logits against the
  JAX ``decode_forward`` on the converted weights and the same cache, within
  2e-2 of the logits' scale (the JAX oracle rounds the dequantized int4
  weights to bf16, the port's int4 math does not); the fused route against
  the unfused within 5e-2 of the scale (two layers; the card's 32-layer
  check in ``chip_smoke.py`` allows 0.10);
* ``dryrun.entry(cfg=tiny, device="cpu")``: ``mm_tokens`` within 1e-3 and
  ``mm_valid`` exactly against the JAX ``perceive`` on the converted
  weights and the same inputs (``test_torch_perceive.py``'s tolerance).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.models.vlm import phi3 as tphi3
from tests.test_spec_decode import _cfg, _quantized_eligible
from tests.test_torch_phi3 import _tcfg
from tests.torch_parity import np32, port_config, slice_config, to_torch


@pytest.fixture(scope="module")
def phi3_int4():
    cfg = _cfg()
    params = _quantized_eligible(cfg, seed=41)
    return cfg, params, to_torch(params)


# --- force-accept ------------------------------------------------------------

def _force(monkeypatch, on: bool):
    from dynam3d_tpu import flags as jflags

    monkeypatch.setattr(jflags, "SPEC_FORCE_ACCEPT", on)
    if on:
        monkeypatch.setenv("DYNAM3D_SPEC_FORCE_ACCEPT", "1")
    else:
        monkeypatch.delenv("DYNAM3D_SPEC_FORCE_ACCEPT", raising=False)
    jax.clear_caches()           # the JAX functions read the flag while tracing


def _prompt(cfg, B, seed, T=24):
    rng = np.random.default_rng(seed)
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(B, T, cfg.hidden_size)), jnp.bfloat16)
    valid = np.ones((B, T), bool)
    for b in range(B):
        valid[b, T - 3 * b - 2: T - 3 * b] = False
    return embeds, valid


def test_force_accept_spec_matches_jax(monkeypatch, phi3_int4):
    cfg, params, tparams = phi3_int4
    n = 10
    embeds, valid = _prompt(cfg, 1, 41)
    te, tv = torch.from_numpy(np32(embeds)).to(torch.bfloat16), torch.from_numpy(valid)
    _force(monkeypatch, True)
    jout = jax.jit(lambda p, e, v: jphi3.greedy_decode_spec(p, cfg, e, v, n, stop_token=-1))(
        params, embeds, jnp.asarray(valid))
    stats = {}
    tout = tphi3.greedy_decode_spec(tparams, _tcfg(cfg), te, tv, n, stop_token=-1, stats=stats)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert stats["passes"] == -(-(n - 1) // 8) and stats["tokens"] == n
    _force(monkeypatch, False)


def test_force_accept_spec_batched_matches_jax(monkeypatch, phi3_int4):
    cfg, params, tparams = phi3_int4
    n, B = 10, 2
    embeds, valid = _prompt(cfg, B, 42)
    _force(monkeypatch, True)
    jout = jax.jit(lambda p, e, v: jphi3.greedy_decode_spec_batched(
        p, cfg, e, v, n, stop_token=-1))(params, embeds, jnp.asarray(valid))
    stats = {}
    tout = tphi3.greedy_decode_spec(
        tparams, _tcfg(cfg), torch.from_numpy(np32(embeds)).to(torch.bfloat16),
        torch.from_numpy(valid), n, stop_token=-1, stats=stats)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert stats["passes"] == -(-(n - 1) // 4)            # g = 8 // B rows a pass
    _force(monkeypatch, False)


# --- prof_decode_parts -------------------------------------------------------

def test_prof_decode_parts_cpu_logits_match_jax(phi3_int4):
    from dynam3d_torch.tools import prof_decode_parts as pdp

    cfg, params, tparams = phi3_int4
    pos, tmax = 40, 512
    tcfg = _tcfg(cfg)
    out = pdp.run(tparams, tcfg, torch.device("cpu"), tmax=tmax, pos=pos)
    assert out["parts"] == []                                  # no times on the CPU
    par = out["parity"]
    inp = pdp.layer_inputs(tcfg, torch.device("cpu"), tmax, pos)
    L, H, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    ck, cv = (jnp.asarray(np32(inp[k]).reshape(L, 1, tmax, H, hd), jnp.bfloat16)
              for k in ("ck", "cv"))
    valid = np.asarray(inp["mask"].numpy())[None].copy()
    valid[0, pos] = True
    lj, _ = jax.jit(lambda p, e, c: jphi3.decode_forward(
        p, cfg, e, jnp.full((1, 1), pos, jnp.int32), jphi3.KVCache(*c), pos,
        jnp.asarray(valid)[:, None, :]))(params, jnp.asarray(np32(inp["e"]), jnp.bfloat16),
                                         (ck, cv))
    lj = np.asarray(lj, np.float32)[0, 0]
    scale = np.abs(lj).max()
    np.testing.assert_allclose(par["logits_unfused"], lj, atol=2e-2 * scale, rtol=0)
    assert par["fused"] and par["max_abs"] <= 5e-2 * par["scale"]


# --- the compile-check entry -------------------------------------------------

def test_entry_matches_jax_perceive(monkeypatch):
    from dynam3d_torch.models import policy as tpolicy
    from dynam3d_torch.parallel.dryrun import entry

    jcfg = slice_config()
    jp = jax.jit(lambda k: jpolicy.init_policy_params(k, jcfg, llm_dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    monkeypatch.setattr(tpolicy, "init_policy_params", lambda *a, **k: to_torch(jp))
    fn, args = entry(cfg=port_config(jcfg), device="cpu")
    tm, tv = fn(*args)
    _, _, rgb, depth, pos, hd = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    jout = jax.jit(lambda *a: jpolicy.perceive(*a[:1], jcfg, *a[1:]))(
        jp, jpolicy.batched_init_state(jcfg, 1), jnp.asarray(rgb), jnp.asarray(depth),
        jnp.asarray(pos), jnp.asarray(hd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jout.mm_valid))
    np.testing.assert_allclose(np32(tm), np32(jout.mm_tokens), rtol=1e-3, atol=1e-3)
