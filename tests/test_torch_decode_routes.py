"""Greedy ids through ``llava.generate`` on every int4 decode route the
decode flags and the batch select (ring, split, unfused, 2-D matvec,
grouped speculation, the wide route's kernel B at B = 12 and the unfused
attention with kernel F there; B = 1, 3, 6 and 12), each shown by the
plain versions it ran, identical to the JAX package's ids (its CPU path,
``decode_forward`` over dequantized weights); and ``decode_route``'s
answer table.  The routes' kernels are tested in test_torch_int4_mlp.py
and test_torch_attn_layer.py.

The tiny random model's logits are nearly flat, and the JAX CPU path
rounds the dequantized weights to bf16 where the port's int4 arithmetic is
exact, so at some seeds a greedy step is a near-tie that the two packages
break differently (B=12, seed 12: row 3, step 3, logits 0.530 vs 0.512 for
the two candidates; jitting the reference's call moves such steps too).
The seeds below have no such step for the reference called as its own
tests call it (not jitted)."""

import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import Dynam3DConfig, LLaVAConfig
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.models.vlm import llava as tllava
from dynam3d_torch.config import Phi3Config
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.ops import decode as tdecode
from dynam3d_torch.ops import int4 as tint4
from tests.test_spec_decode import _cfg, _quantized_eligible
from tests.torch_parity import np32, port_config, to_torch


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# route name, batch, decode flags, plain versions that must run / must not run
ROUTES = [
    ("ring_spec", 1, {}, {"ring"}, {"H", "G", "F", "E"}),
    ("split", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_SPEC_DECODE": "0"}, {"H", "G"},
     {"ring", "F", "E"}),
    ("unfused_spec", 1, {"DYNAM3D_FUSED_RING": "0"}, {"F"}, {"ring", "H", "G", "E"}),
    ("unfused_spec_grid2d", 1, {"DYNAM3D_FUSED_RING": "0", "DYNAM3D_INT4_GRID2D": "1"},
     {"F", "E"}, {"ring", "H", "G"}),
    ("fused_attn_off", 1, {"DYNAM3D_FUSED_ATTN": "0"}, {"F"}, {"ring", "H", "G", "E"}),
    ("grouped_spec", 3, {}, {"ring_group"}, {"H", "G", "F", "E"}),
    ("ring_greedy", 6, {}, {"ring"}, {"H", "G", "F", "E"}),
    ("unfused", 12, {}, {"B", "F"}, {"ring", "H", "G", "E"}),
    ("unfused_b12", 12, {"DYNAM3D_FUSED_ATTN": "0"}, {"F"}, {"ring", "B", "H", "G", "E"}),
]


def _spy(monkeypatch, mod, name, tag, seen):
    real = getattr(mod, name)

    def spy(*a, **k):
        grouped = 1 < k.get("group", 1) < a[0].shape[0]     # B episodes x g drafts
        seen.add(tag + ("_group" if grouped else ""))
        return real(*a, **k)

    monkeypatch.setattr(mod, name, spy)


SEEDS = {1: 1, 3: 3, 6: 7, 12: 7}     # per batch size, see the module docstring


@functools.lru_cache(maxsize=None)
def _reference(B):
    """Params, prompt and the JAX package's greedy ids at batch B."""
    cfg = _cfg()
    qparams = _quantized_eligible(cfg, seed=SEEDS[B])
    rng = np.random.default_rng(SEEDS[B])
    T, n = 24, 10
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(B, T, cfg.hidden_size)), jnp.bfloat16)
    valid = np.ones((B, T), bool)
    for b in range(B):
        valid[b, T - 2 - (b % 5): T - (b % 5)] = False
    ref = np.asarray(jphi3.greedy_decode(qparams, cfg, embeds, jnp.asarray(valid), n))
    return cfg, qparams, embeds, valid, n, ref


@pytest.mark.parametrize("route,B,env,must,never", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_ids_match_reference(monkeypatch, route, B, env, must, never):
    cfg, qparams, embeds, valid, n, ref = _reference(B)
    seen = set()
    _spy(monkeypatch, tphi3, "decode_layer_ring", "ring", seen)
    _spy(monkeypatch, tdecode, "decode_attn_plain", "B", seen)
    _spy(monkeypatch, tdecode, "decode_attn_layer_plain", "H", seen)
    _spy(monkeypatch, tint4, "int4_mlp_block_plain", "G", seen)
    _spy(monkeypatch, tint4, "int4_mlp_plain", "F", seen)
    _spy(monkeypatch, tint4, "int4_matvec2d_plain", "E", seen)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    lcfg = port_config(Dynam3DConfig(llava=LLaVAConfig(phi3=cfg, max_new_tokens=n))).llava
    got = tllava.generate({"phi3": to_torch(qparams)}, lcfg, _bf(np32(embeds)),
                          torch.from_numpy(valid))
    assert must <= seen and not (never & seen), (route, seen)
    np.testing.assert_array_equal(got.numpy(), ref)


# decode_route's answers, as the parent's five predicates gave them at
# their greedy call site: rows 1, 3, 6, 12, 17 under DYNAM3D_FUSED_RING on
# and off, and rows 1 and 12 under tp
ROUTE_TABLE = {
    "int4_ring": {"1": ["ring", "ring", "ring", "wide", "unfused"],
                  "0": ["split", "unfused", "unfused", "wide", "unfused"]},
    "int4_few_blocks": {"1": ["split", "unfused", "unfused", "wide", "unfused"],
                        "0": ["split", "unfused", "unfused", "wide", "unfused"]},
    "int8": {f: ["unfused"] * 5 for f in "10"},
    "dense": {f: ["unfused"] * 5 for f in "10"},
}
ROUTE_CASES = ([(w, f, rows, False, want) for w, by in ROUTE_TABLE.items()
                for f, answers in by.items() for rows, want in zip((1, 3, 6, 12, 17), answers)]
               + [(w, "1", rows, True, "unfused") for w in ROUTE_TABLE for rows in (1, 12)])
ROUTE_CFG = Phi3Config(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=4, head_dim=32)


@functools.lru_cache(maxsize=None)
def _route_params(weights):
    """Ring packs (64-row groups, 64-wide blocks); the same packs at an
    MLP of 128, whose gate_up has 2 column blocks, too few for the ring;
    int8 only; dense."""
    cfg = (dataclasses.replace(ROUTE_CFG, intermediate_size=128)
           if weights == "int4_few_blocks" else ROUTE_CFG)
    dense = tphi3.init_phi3_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    if weights == "dense":
        return dense
    q = tphi3.quantize_phi3(dense, bits=8 if weights == "int8" else 4)
    if weights != "int8":
        for lq, ld in zip(q["layers"], dense["layers"]):
            for name in ("qkv", "o", "gate_up", "down"):
                lq[name]["q4"] = tint4.pack_int4(ld[name].float(), dblk=64, nblk=64)
    return q


@pytest.mark.parametrize("weights,ring,rows,tp,want", ROUTE_CASES,
                         ids=[f"{w}-ring{f}-rows{r}{'-tp' if t else ''}"
                              for w, f, r, t, _ in ROUTE_CASES])
def test_decode_route_table(monkeypatch, weights, ring, rows, tp, want):
    monkeypatch.setenv("DYNAM3D_FUSED_RING", ring)
    monkeypatch.delenv("DYNAM3D_FUSED_ATTN", raising=False)
    tp = object() if tp else None                   # only its presence is read
    assert tphi3.decode_route(_route_params(weights), ROUTE_CFG, rows, tp) == want
