"""The slice end to end: a 3-step ``EpisodeRunner.run`` on
``SyntheticRoomFeed`` through the port and through the JAX package with the
same converted weights, on the tiny slice config (depth_plane segmenter,
float32 encoders).  Run once with a dense f32 LLM and once with an
int4-quantized one (repacked with 64-row groups and 32-wide column blocks
so the 64-wide model carries no packing padding).

Generated ids and the decoded action text must be identical at every step
(tests/test_torch_perceive.py holds the perception half alone)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_tpu.ops.pallas_int4 import pack_int4 as jpack
from dynam3d_tpu.runtime.episode import EpisodeRunner as JRunner
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from tests.torch_parity import port_config, slice_config, to_torch


@pytest.fixture(scope="module")
def slice_params():
    cfg = slice_config()
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), cfg, llm_dtype=jnp.float32)
    return cfg, port_config(cfg), jp


def _int4(jp, cfg):
    ph = jp["llava"]["phi3"]
    q = jphi3.quantize_phi3(ph, bits=4)
    for li in range(cfg.llava.phi3.num_layers):
        for name in ("qkv", "o", "gate_up", "down"):
            q["layers"][li][name]["q4"] = jpack(
                ph["layers"][li][name].astype(jnp.float32), dblk=64, nblk=32)
    out = dict(jp)
    out["llava"] = dict(jp["llava"], phi3=q)
    return out


@pytest.mark.parametrize("llm", ["dense_f32", "int4"])
def test_episode_ids_and_text_identical(slice_params, llm):
    jcfg, tcfg, jp = slice_params
    if llm == "int4":
        jp = _int4(jp, jcfg)
    tp = to_torch(jp)

    jr = JRunner(jp, jcfg)
    jgens = []
    step = jr._full_step

    def capture(*a, **k):
        st, g = step(*a, **k)
        jgens.append(np.asarray(g)[0].tolist())
        return st, g

    jr._full_step = capture
    jres = jr.run([JFeed(rgb_size=56, depth_size=32, views=1, seed=0)], max_steps=3,
                  ignore_stop=True)
    tr = TRunner(tp, tcfg, device="cpu")
    tres = tr.run([TFeed(rgb_size=56, depth_size=32, views=1, seed=0)], max_steps=3,
                  ignore_stop=True)

    assert len(jgens) == len(tr.step_log) == 3
    for s, jg in zip(tr.step_log, jgens):
        assert s["gen"] == jg, (s["step"], s["gen"], jg)
        text = jr.tok.decode(jg)
        text = text[: text.find("<|end|>")] if "<|end|>" in text else text
        assert s["text"] == text
        assert s["passes"] is not None and 1 <= s["passes"] <= jcfg.llava.max_new_tokens
    assert tres[0]["steps"] == jres[0]["steps"] == 3
    np.testing.assert_allclose(tres[0]["distance_to_goal"], jres[0]["distance_to_goal"],
                               rtol=1e-6)
