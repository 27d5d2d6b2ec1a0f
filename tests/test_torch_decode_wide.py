"""The wide decode route (``phi3._decode_forward_wide``, greedy B = 9..16):
kernel A on qkv and o, kernel B in plain mode over the bf16 cache, the MLP
of ``_mlp``, on the CPU through the plain versions.

A pass of the wide route is held against the unfused ``decode_forward``
pass it replaces, from the same prefilled cache.  Both take the attention
in f32 over bf16 q / k / v; they differ only in where they round to bf16.
Per layer the unfused pass rounds q and k before RoPE as well as after
it, rounds the probabilities P once (kernel B's plain version keeps them
f32), and rounds the o product before the bf16 residual add (A adds the
residual in f32 and rounds once).  Each of those four roundings moves a
value by at most half a bf16 step, 2^-9 of its size, and each value is of
the hidden state's scale, so the hidden states of the two passes part by
at most about 4 * 2 * 2^-9 = 2^-6 of its scale a layer, and the logits by
``num_layers * 2^-6`` of their own scale: ``LOGIT_TOL``.  The same
roundings put the new k one bf16 step apart at most (2^-7 of its scale);
layer 0's new v is the same rounding of the same f32 product on both.
"""

import re
from pathlib import Path

import pytest
import torch

from dynam3d_torch.config import Phi3Config
from dynam3d_torch.models.vlm import phi3
from dynam3d_torch.ops import decode
from dynam3d_torch.ops.int4 import pack_int4
from dynam3d_torch.runtime import profiling

CFG = Phi3Config(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                 num_heads=4, num_kv_heads=4, head_dim=32, pad_token_id=260, end_token_id=257)
LOGIT_TOL = CFG.num_layers * 2.0 ** -6      # of the logits' scale (module docstring)
K_TOL = 2.0 ** -7                           # of the new k's scale
CSRC = Path(__file__).resolve().parents[1] / "dynam3d_torch" / "csrc"


def _params(seed=3):
    """Int4 params at unpadded widths (column blocks of 64), so the fused
    checks hold at the tiny widths."""
    dense = phi3.init_phi3_params(torch.Generator().manual_seed(seed), CFG, device="cpu")
    q = phi3.quantize_phi3(dense, bits=4)
    for lq, ld in zip(q["layers"], dense["layers"]):
        for name in ("qkv", "o", "gate_up", "down"):
            lq[name]["q4"] = pack_int4(ld[name].float(), dblk=64, nblk=64)
    return q


PARAMS = _params()


def _prompt(B, T=40, seed=0):
    """Right-padded prompts of ragged lengths with a hole in each row."""
    gen = torch.Generator().manual_seed(seed)
    e = (torch.randn(B, T, CFG.hidden_size, generator=gen) * 0.5).to(torch.bfloat16)
    valid = torch.ones(B, T, dtype=torch.bool)
    for b in range(B):
        valid[b, T - 1 - (b % 7):] = False
        valid[b, 5 + b % 3] = False
    return e, valid


@pytest.mark.parametrize("B", [9, 12, 16])
def test_wide_pass_matches_unfused_pass(B):
    T, n = 40, 6
    e, valid = _prompt(B, T, seed=B)
    tok, cache = phi3._prefill(PARAMS, CFG, e, valid, T + n)
    v = torch.cat([valid, torch.zeros(B, n, dtype=torch.bool)], 1)
    v[:, T] = True
    x = phi3.embed(PARAMS, tok)[:, None].to(torch.bfloat16)
    pos = (v.sum(1) - 1)[:, None]
    wide = phi3.KVCache(cache.k.clone(), cache.v.clone())
    unfused = phi3.KVCache(cache.k.clone(), cache.v.clone())
    lw, _ = phi3._decode_forward_wide(PARAMS, CFG, x, pos, phi3._flat(wide, CFG), T, v)
    lu, _ = phi3.decode_forward(PARAMS, CFG, x, pos, unfused, T, v[:, None, :])
    assert lw.shape == lu.shape == (B, 1, CFG.vocab_size)
    scale = lu.abs().max().item()
    assert (lw - lu).abs().max().item() <= LOGIT_TOL * scale
    top2 = lu[:, 0].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL * scale
    assert clear.any()
    assert torch.equal(lw[clear, 0].argmax(-1), lu[clear, 0].argmax(-1))
    # the new k / v at the write slot only, every other slot as the prefill left it
    others = torch.ones(T + n, dtype=torch.bool)
    others[T] = False
    for got in (wide, unfused):
        assert torch.equal(got.k[:, :, others], cache.k[:, :, others])
        assert torch.equal(got.v[:, :, others], cache.v[:, :, others])
    kw, ku = wide.k[:, :, T].float(), unfused.k[:, :, T].float()
    assert (kw - ku).abs().max().item() <= K_TOL * ku.abs().max().item()
    assert (ku != 0).any() and (unfused.v[:, :, T] != 0).any()
    assert torch.equal(wide.v[0, :, T], unfused.v[0, :, T])


@pytest.mark.parametrize("B,wide", [(1, False), (6, False), (12, True)])
def test_wide_passes_count_the_route(B, wide):
    e, valid = _prompt(B, T=24, seed=1)
    profiling.reset()
    profiling.enable()
    try:
        ids = phi3.greedy_decode(PARAMS, CFG, e, valid, 5, stop_token=-1)
        c = profiling.counts()
    finally:
        profiling.disable()
        profiling.reset()
    assert ids.shape == (B, 5)
    assert c.get("decode.passes", 0) >= 4
    assert c.get("decode.wide_passes", 0) == (c["decode.passes"] if wide else 0)


def test_wide_route_is_chosen_by_the_batch(monkeypatch):
    assert [B for B in range(1, 20) if phi3.decode_route(PARAMS, CFG, B) == "wide"] == list(
        range(9, 17))
    monkeypatch.setenv("DYNAM3D_FUSED_ATTN", "0")
    assert phi3.decode_route(PARAMS, CFG, 12) == "unfused"


def test_wide_route_runs_kernel_b_a_and_f(monkeypatch):
    seen = []
    for mod, name in ((decode, "decode_attn_plain"), (phi3, "decode_layer_ring"),
                      (phi3, "int4_mlp"), (phi3, "int4_matvec")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    e, valid = _prompt(12, T=24, seed=2)
    phi3.greedy_decode(PARAMS, CFG, e, valid, 3, stop_token=-1)
    passes = 3
    assert seen.count("decode_layer_ring") == 0
    assert seen.count("decode_attn_plain") == passes * CFG.num_layers
    assert seen.count("int4_mlp") == passes * CFG.num_layers
    assert seen.count("int4_matvec") == passes * 2 * CFG.num_layers


def test_prefill_attends_over_t_plus_max_new(monkeypatch):
    widths = []
    real = phi3.prefill_mask

    def spy(attn_valid, cache_len):
        m = real(attn_valid, cache_len)
        widths.append(m.shape[-1])
        return m

    monkeypatch.setattr(phi3, "prefill_mask", spy)
    T, n = 24, 7
    e, valid = _prompt(12, T=T, seed=4)
    phi3.greedy_decode(PARAMS, CFG, e, valid, n, stop_token=-1)
    assert widths == [T + n]


def test_check_attn_takes_16_rows_in_groups_of_8():
    H, hd = CFG.num_heads, CFG.head_dim
    D = H * hd

    def check(rows, group):
        cache = torch.zeros(1, rows // group, 64, D, dtype=torch.bfloat16)
        decode._check_attn(torch.zeros(rows, 3 * D), cache, cache, group, H, hd)

    check(16, 1)
    check(16, 8)
    check(8, 8)
    with pytest.raises(ValueError, match="rows must be 1..16"):
        check(17, 1)
    with pytest.raises(ValueError, match="group must be 1..8"):
        check(9, 9)
    src = (CSRC / "decode_attn.cu").read_text()
    assert re.search(rf"constexpr int kMaxBatch = {decode.ATTN_ROWS};", src)
    assert "rows > kMaxBatch" in src and "group > da::kMaxRows" in src


def test_kernel_b_plain_at_16_rows_equals_one_row_at_a_time():
    """Plain mode at 16 rows is 16 independent one-row calls."""
    H, hd = CFG.num_heads, CFG.head_dim
    D, rows, tmax = H * hd, 16, 100
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(rows, 3 * D, generator=gen)
    ck = torch.randn(1, rows, tmax, D, generator=gen).to(torch.bfloat16)
    cv = torch.randn(1, rows, tmax, D, generator=gen).to(torch.bfloat16)
    mask = torch.rand(rows, tmax, generator=gen) > 0.3
    ang = torch.rand(rows, hd // 2, generator=gen) * 3
    cos, sin = torch.cos(ang), torch.sin(ang)
    t_scan = 83
    got = decode.decode_attn_plain(qkv, cos, sin, ck, cv, 0, mask, t_scan, 1, heads=H, hd=hd)
    for r in range(rows):
        one = decode.decode_attn_plain(qkv[r:r + 1], cos[r:r + 1], sin[r:r + 1],
                                       ck[:, r:r + 1], cv[:, r:r + 1], 0, mask[r:r + 1],
                                       t_scan, 1, heads=H, hd=hd)
        for a, b in zip(got, one):
            assert torch.equal(a[r:r + 1], b)
