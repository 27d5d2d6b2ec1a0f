"""Port parity of batched multi-episode serving against the JAX package:

* ``greedy_decode_spec_batched`` at B = 2, 3 and 4 with lookup ids planted
  from the port's own greedy ids (drafts hit): ids and the ``tokens`` /
  ``passes`` stats equal the JAX package's, and the ids the port's plain
  greedy decode, over int4 weights (the port's grouped ring verify, plain
  versions) and over dense weights (the grouped ``decode_forward`` verify
  with per-row cache scatters);
* ``EpisodeRunner.run`` with 3 feeds on the tiny slice config (int4 LLM):
  identical ids and action text for every feed at every step (B >= 9 runs
  through ``llava.generate`` in test_torch_decode_routes.py, where the JAX
  episode's compile would not fit this file's time);
* ``run_interleaved``: results in feed order, equal to each feed's own run.

Ids, stats and text exact."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_tpu.ops.pallas_int4 import pack_int4 as jpack
from dynam3d_tpu.runtime.episode import EpisodeRunner as JRunner
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from tests.test_spec_decode import _cfg, _quantized_eligible
from tests.test_torch_phi3 import _tcfg
from tests.torch_parity import np32, port_config, slice_config, to_torch


def _prompt(cfg, B, seed, T=24):
    rng = np.random.default_rng(seed)
    embeds = jnp.asarray(rng.normal(scale=0.5, size=(B, T, cfg.hidden_size)), jnp.bfloat16)
    valid = np.ones((B, T), bool)
    for b in range(B):
        valid[b, T - 3 * b - 2: T - 3 * b] = False          # per-row holes
    return embeds, valid


@pytest.mark.parametrize("B,llm", [(2, "int4"), (3, "int4"), (4, "int4"), (3, "dense")])
def test_spec_batched_ids_and_stats_match(B, llm):
    cfg = _cfg()
    if llm == "int4":
        params = _quantized_eligible(cfg, seed=30 + B)
    else:
        params = jphi3.init_phi3_params(jax.random.PRNGKey(30 + B), cfg)
    embeds, valid = _prompt(cfg, B, 30 + B)
    n = 10
    tparams, te, tv = (to_torch(params), torch.from_numpy(np32(embeds)).to(torch.bfloat16),
                       torch.from_numpy(valid))
    ref = tphi3.greedy_decode(tparams, _tcfg(cfg), te, tv, n, stop_token=-1).numpy()
    lookup = np.full((B, n + 8), -1, np.int32)
    lookup[:, 3: 3 + n] = ref                                # drafts hit
    lookup[B - 1, 3: 3 + n] = -1                             # ... except on the last row
    jout, jstats = jax.jit(lambda p, e, v, lk: jphi3.greedy_decode_spec_batched(
        p, cfg, e, v, n, stop_token=-1, lookup_ids=lk, return_stats=True))(
        params, embeds, jnp.asarray(valid), jnp.asarray(lookup))
    stats = {}
    tout = tphi3.greedy_decode_spec_batched(tparams, _tcfg(cfg), te, tv, n, stop_token=-1,
                                            lookup_ids=torch.from_numpy(lookup), stats=stats)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), ref)
    assert stats["tokens"] == np.asarray(jstats["tokens"]).tolist() == [n] * B
    assert stats["passes"] == int(jstats["passes"]) < n


def test_spec_batched_stop_per_row():
    """Rows stop independently: a stop token row 0 emits early; the other
    rows go on and the finished row pads, as greedy_decode does."""
    cfg = _cfg()
    params = _quantized_eligible(cfg, seed=33)
    embeds, valid = _prompt(cfg, 2, 33)
    n = 10
    free = np.asarray(jphi3.greedy_decode(params, cfg, embeds, jnp.asarray(valid), n,
                                          stop_token=-1))
    stop = int(free[0, 3])
    ref = np.asarray(jphi3.greedy_decode(params, cfg, embeds, jnp.asarray(valid), n,
                                         stop_token=stop))
    tout = tphi3.greedy_decode_spec_batched(
        to_torch(params), _tcfg(cfg), torch.from_numpy(np32(embeds)).to(torch.bfloat16),
        torch.from_numpy(valid), n, stop_token=stop)
    np.testing.assert_array_equal(tout.numpy(), ref)


@pytest.fixture(scope="module")
def slice_int4():
    cfg = slice_config()
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), cfg, llm_dtype=jnp.float32)
    ph = jp["llava"]["phi3"]
    q = jphi3.quantize_phi3(ph, bits=4)
    for li in range(cfg.llava.phi3.num_layers):
        for name in ("qkv", "o", "gate_up", "down"):
            q["layers"][li][name]["q4"] = jpack(ph["layers"][li][name].astype(jnp.float32),
                                                dblk=64, nblk=32)
    jp = dict(jp, llava=dict(jp["llava"], phi3=q))
    return cfg, port_config(cfg), jp, to_torch(jp)


def test_episode_runner_three_feeds_identical(slice_int4):
    jcfg, tcfg, jp, tp = slice_int4
    jr = JRunner(jp, jcfg)
    jgens = []
    step = jr._full_step

    def capture(*a, **k):
        st, g = step(*a, **k)
        jgens.append(np.asarray(g).tolist())
        return st, g

    jr._full_step = capture
    feeds = lambda cls: [cls(rgb_size=56, depth_size=32, views=1, seed=s) for s in (0, 1, 2)]
    jres = jr.run(feeds(JFeed), max_steps=2, ignore_stop=True)
    tr = TRunner(tp, tcfg, device="cpu")
    tres = tr.run(feeds(TFeed), max_steps=2, ignore_stop=True)
    assert len(jgens) == len(tr.step_log) == 2
    for s, jg in zip(tr.step_log, jgens):
        assert s["gens"] == jg, (s["step"], s["gens"], jg)
        for row, g in enumerate(jg):
            text = jr.tok.decode(g)
            assert s["texts"][row] == (text[: text.find("<|end|>")] if "<|end|>" in text
                                       else text)
        assert isinstance(s["tokens"], list) and len(s["tokens"]) == 3   # grouped speculation
    for t, j in zip(tres, jres):
        assert t["steps"] == j["steps"] == 2
        np.testing.assert_allclose(t["distance_to_goal"], j["distance_to_goal"], rtol=1e-6)


def test_run_interleaved_results_in_feed_order(slice_int4):
    _, tcfg, _, tp = slice_int4

    def feed(i):                      # a goal per feed: its result names it
        return TFeed(rgb_size=56, depth_size=32, views=1, goal=(6.0 - i, 6.0), seed=i)

    got = TRunner(tp, tcfg, device="cpu").run_interleaved(
        [feed(i) for i in range(4)], groups=2, max_steps=2, ignore_stop=True)
    alone = [TRunner(tp, tcfg, device="cpu").run([feed(i)], max_steps=2, ignore_stop=True)[0]
             for i in range(4)]
    assert len(got) == 4
    for g, a in zip(got, alone):
        assert g["steps"] == a["steps"]
        np.testing.assert_allclose(g["distance_to_goal"], a["distance_to_goal"], rtol=1e-6)
    assert len({round(g["distance_to_goal"], 4) for g in got}) == 4
