"""Greedy ids through ``llava.generate`` on every int4 decode route the
decode flags and the batch select (ring, split, unfused, 2-D matvec,
grouped speculation; B = 1, 3, 6 and 12), each shown by the plain versions
it ran, identical to the JAX package's ids (its CPU path,
``decode_forward`` over dequantized weights).  The routes' kernels are
tested in test_torch_int4_mlp.py and test_torch_attn_layer.py.

The tiny random model's logits are nearly flat, and the JAX CPU path
rounds the dequantized weights to bf16 where the port's int4 arithmetic is
exact, so at some seeds a greedy step is a near-tie that the two packages
break differently (B=12, seed 12: row 3, step 3, logits 0.530 vs 0.512 for
the two candidates; jitting the reference's call moves such steps too).
The seeds below have no such step for the reference called as its own
tests call it (not jitted)."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import Dynam3DConfig, LLaVAConfig
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.models.vlm import llava as tllava
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
    ("unfused", 12, {}, {"F"}, {"ring", "H", "G", "E"}),
    ("unfused_split_mlp", 12, {"DYNAM3D_INT4_FUSED_MLP": "0"}, set(),
     {"ring", "H", "G", "F", "E"}),
]


def _spy(monkeypatch, mod, name, tag, seen):
    real = getattr(mod, name)

    def spy(*a, **k):
        seen.add(tag + ("_group" if k.get("group_size") else ""))
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
