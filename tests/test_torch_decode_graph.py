"""The B=1 ring pass over long-lived buffers (``phi3._ring_pass``), the body
that the card captures once per ``(rows, Tmax, t_scan)`` and replays.

On the CPU the same body runs eagerly through the plain versions.  Held
bit for bit against the pass run eagerly with host ints: a verify pass of
8 rows as a layer loop with slice writes of the new k/v at the write
slots, and a plain one-row pass as greedy decode runs it
(``_decode_forward_ring``: a mask cloned with the current slot cleared,
ids uploaded for the embedding): logits, argmax and the whole cache after
the pass, with write slots inside the first 512-row block, across its
edge and past it.  Two ``greedy_decode_spec`` calls at different prompt
lengths share one buffer, and the second equals the same call on fresh
buffers; the graph key and the CPU's counters (no replay, no capture)."""

import numpy as np
import pytest
import torch

from dynam3d_torch.config import Phi3Config
from dynam3d_torch.models.vlm import phi3
from dynam3d_torch.ops.decode import decode_layer_ring, scan_length
from dynam3d_torch.ops.int4 import pack_int4
from dynam3d_torch.runtime import profiling

CFG = Phi3Config(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                 num_heads=4, num_kv_heads=4, head_dim=32, pad_token_id=260, end_token_id=257)


def _params(seed):
    """Tiny int4 params repacked with 64-row groups and 64-wide blocks, so
    the ring is eligible at these widths."""
    dense = phi3.init_phi3_params(torch.Generator().manual_seed(seed), CFG, device="cpu")
    q = phi3.quantize_phi3(dense, bits=4)
    for lq, ld in zip(q["layers"], dense["layers"]):
        for name in ("qkv", "o", "gate_up", "down"):
            lq[name]["q4"] = pack_int4(ld[name].float(), dblk=64, nblk=64)
    assert phi3.decode_route(q, CFG, 1) == "ring"
    return q


def _prompt(seed, T):
    g = torch.Generator().manual_seed(seed)
    embeds = (torch.randn(1, T, CFG.hidden_size, generator=g) * 0.5).to(torch.bfloat16)
    valid = torch.ones(1, T, dtype=torch.bool)
    valid[0, 10:13] = False
    return embeds, valid


def _verify_as_eager(params, cfg, embeds, pos0, cache, wslot, valid):
    """The verify pass as the eager route ran it: host-int slot slices."""
    _, k, D = embeds.shape
    cos, sin = phi3._rope_table(cfg, pos0 + torch.arange(k))
    x = embeds[0][:, None, :]
    for li in range(cfg.num_layers):
        p = params["layers"][li]
        x, k_new, v_new = decode_layer_ring(
            x, p["input_ln"], p["qkv"]["q4"], p["o"]["q4"], p["post_ln"],
            p["gate_up"]["q4"], p["down"]["q4"], cache.k, cache.v, li,
            scan_length(wslot, cache.k.shape[2]), valid, cos, sin, eps=cfg.rms_eps,
            heads=cfg.num_heads, hd=cfg.head_dim, group=k,
        )
        cache.k[li, 0, wslot: wslot + k] = k_new
        cache.v[li, 0, wslot: wslot + k] = v_new
    x = phi3.rms_norm(params["final_ln"], x.reshape(1, k, D), cfg.rms_eps)
    return phi3._lm_head(params, x)


@pytest.mark.parametrize("rows,T,total", [
    (8, 30, 512),
    (1, 30, 512),
    (8, 509, 1024),        # write slots 509..516 cross the first block's edge
    (1, 513, 1024),        # the slot past it: t_scan 1024
])
def test_ring_pass_equals_eager_pass(monkeypatch, rows, T, total):
    monkeypatch.setattr(phi3, "_ring_buffers", {})
    params = _params(rows + T)
    embeds, attn_valid = _prompt(T, T)
    buf = phi3._buffers(CFG, total, torch.bfloat16, torch.device("cpu"))
    phi3._prefill(params, CFG, embeds, attn_valid, total, cache=buf.cache)
    buf.valid[:, :T] = attn_valid
    ref_cache = phi3._flat(phi3.KVCache(buf.cache.k.clone(), buf.cache.v.clone()), CFG)
    ref_valid = buf.valid.clone()

    ids = np.array([5, 17, 3, 250, 9, 77, 1, 300][:rows])
    pos0, wslot = int(attn_valid.sum()), T
    e = phi3.embed(params, torch.as_tensor(ids))[None].to(torch.bfloat16)
    if rows > 1:
        ref = _verify_as_eager(params, CFG, e, pos0, ref_cache, wslot, ref_valid)
    else:
        ref, _ = phi3._decode_forward_ring(params, CFG, e, torch.full((1, 1), pos0), ref_cache,
                                           wslot, ref_valid)
        ref = ref.view(1, rows, -1)
    lg, top = phi3._ring_pass(params, CFG, buf, ids, pos0, wslot)
    assert lg.shape == ref.shape == (1, rows, CFG.vocab_size)
    assert torch.equal(lg, ref)
    assert torch.equal(top, ref[0].argmax(-1))
    flat = phi3._flat(buf.cache, CFG)
    assert torch.equal(flat.k, ref_cache.k) and torch.equal(flat.v, ref_cache.v)
    assert flat.k[:, 0, wslot: wslot + rows].abs().sum() > 0
    assert torch.equal(buf.valid, ref_valid)


def test_two_spec_calls_share_one_buffer(monkeypatch):
    params = _params(3)
    n = 12
    lookup = torch.full((n + 8,), -1, dtype=torch.int64)
    prompts = [_prompt(40, 40), _prompt(24, 24)]     # the longer first: its rows must go
    free = phi3.greedy_decode(params, CFG, *prompts[1], n, stop_token=-1)
    lookup[3: 3 + n] = free[0]                       # drafts hit: verify passes too

    monkeypatch.setattr(phi3, "_ring_buffers", {})
    outs = [phi3.greedy_decode_spec(params, CFG, e, v, n, stop_token=-1, lookup_ids=lookup)
            for e, v in prompts]
    assert list(phi3._ring_buffers) == [(torch.device("cpu"), torch.bfloat16, 2, 4, 32, 512)]
    monkeypatch.setattr(phi3, "_ring_buffers", {})
    stats = {}
    fresh = phi3.greedy_decode_spec(params, CFG, *prompts[1], n, stop_token=-1,
                                    lookup_ids=lookup, stats=stats)
    assert torch.equal(outs[1], fresh)
    assert torch.equal(fresh, free)
    assert stats["passes"] < n - 1


def test_graph_key_and_cpu_counters(monkeypatch):
    assert phi3._graph_key(8, 1536, 1000) == (8, 1536, 1024)
    assert phi3._graph_key(1, 1536, 1024) == (1, 1536, 1024)
    assert phi3._graph_key(1, 1536, 1025) == (1, 1536, 1536)
    assert phi3._graph_key(8, 1024, 3) == (8, 1024, 512)
    monkeypatch.setattr(phi3, "_ring_buffers", {})
    monkeypatch.setattr(phi3, "_graphs", {})
    params = _params(5)
    embeds, valid = _prompt(5, 24)
    profiling.reset()
    profiling.enable()
    try:
        phi3.greedy_decode_spec(params, CFG, embeds, valid, 10, stop_token=-1)
    finally:
        profiling.disable()
    c = profiling.counts()
    profiling.reset()
    assert c["decode.passes"] >= 1
    assert c.get("decode.graph_replays", 0) == 0 and c.get("decode.graph_captures", 0) == 0
    assert phi3._graphs == {}


def test_threads_share_the_buffers_one_call_at_a_time(monkeypatch):
    """More threads than cores decode at once into the one buffer of their
    Tmax (``run_interleaved`` decodes from threads): each gets the ids it
    gets alone."""
    import os
    import sys
    import threading

    params = _params(9)
    n = min(len(os.sched_getaffinity(0)), 32) + 2
    prompts = [_prompt(s, 20 + 4 * (s % 5)) for s in range(n)]
    monkeypatch.setattr(phi3, "_ring_buffers", {})
    alone = [phi3.greedy_decode_spec(params, CFG, e, v, 10, stop_token=-1) for e, v in prompts]
    got = [None] * len(prompts)

    def run(i):
        got[i] = phi3.greedy_decode_spec(params, CFG, *prompts[i], 10, stop_token=-1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(phi3._ring_buffers) == 1
    for a, b in zip(alone, got):
        assert b is not None and torch.equal(a, b)


def test_buffers_keep_the_most_recent_cache_lengths(monkeypatch):
    """A cache length past ``_TMAX_KEPT`` drops the least recently used
    length's buffers and the graphs that read them; a use makes a length
    the most recent."""
    monkeypatch.setattr(phi3, "_ring_buffers", {})
    monkeypatch.setattr(phi3, "_graphs", {})
    monkeypatch.setattr(phi3, "_TMAX_KEPT", 3)
    cpu = torch.device("cpu")

    def buffers(tmax):
        return phi3._buffers(CFG, tmax, torch.bfloat16, cpu)

    bufs = {t: buffers(t) for t in (512, 1024, 1536)}
    for t, b in bufs.items():
        for rows in (1, 8):
            phi3._graphs[(rows, t, t)] = phi3._Graph(None, (), {}, (b, None, None))
    assert buffers(512) is bufs[512]
    assert [k[-1] for k in phi3._ring_buffers] == [1024, 1536, 512]
    buffers(2048)
    assert [k[-1] for k in phi3._ring_buffers] == [1536, 512, 2048]
    assert sorted(phi3._graphs) == [(1, 512, 512), (1, 1536, 1536), (8, 512, 512),
                                    (8, 1536, 1536)]
    buffers(1024)
    assert [k[-1] for k in phi3._ring_buffers] == [512, 2048, 1024]
    assert buffers(1024) is not bufs[1024]
    assert sorted(phi3._graphs) == [(1, 512, 512), (8, 512, 512)]
