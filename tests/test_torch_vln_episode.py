"""``VLNTrainer.train_episode`` through the port and the JAX package on the
same converted weights: the tiny slice config (depth_plane segmenter,
float32 encoders and Phi-3) on a 12-view ``SyntheticRoomFeed``, so the
teacher's candidates come from the frozen waypoint predictor at every step
(depth encoder at ``input_size`` 64, one TRM layer).  lr 1e-3, so each
step's update moves the next step's loss.

Per step: the same candidates (angles within an f32 ulp), the same gt text, and losses within 1e-4
relative (perception's float32 towers and aggregation sum in another
order, 1e-3 on the multimodal tokens, ``test_torch_perceive.py``)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.models.encoders.depth_resnet import init_depth_params as jinit_depth
from dynam3d_tpu.models.waypoint.trm import init_waypoint_params as jinit_wp
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_tpu.runtime.vln_loop import VLNTrainer as JTrainer
from dynam3d_torch.convert import conv_params_from_jax
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from dynam3d_torch.runtime.vln_loop import VLNTrainer as TTrainer
from tests.torch_parity import port_config, slice_config, to_torch

STEPS = 3


def _feed(mod, cfg):
    return mod(rgb_size=56, depth_size=cfg.depth.input_size, views=12, seed=3)


@pytest.fixture(scope="module")
def episodes():
    jcfg = slice_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, lr=1e-3))
    tcfg = port_config(jcfg)
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    de = jinit_depth(jax.random.PRNGKey(4), jcfg.depth)
    wp = jinit_wp(jax.random.PRNGKey(3), jcfg.waypoint, depth_feat_dim=128)
    # converted before the JAX trainer's first step donates its buffers
    tp = to_torch(jp)
    tde = conv_params_from_jax(jax.tree_util.tree_map(np.asarray, de), device="cpu")
    twp = to_torch(wp)

    jt = JTrainer(jp, jcfg, lambda: _feed(JFeed, jcfg), waypoint_params=wp,
                  depth_enc_params=de)
    jlog = []
    step_fn, tok_fn, cand_fn = jt._step_fn, jt._tokenize_full, jt._candidates

    def tok_spy(instruction, history, gt):
        jlog.append({"gt": gt})
        return tok_fn(instruction, history, gt)

    def step_spy(*a):
        out = step_fn(*a)
        jlog[-1]["loss"] = float(out[3]["loss"])
        return out

    def cand_spy(feed, obs):
        c = cand_fn(feed, obs)
        jlog.append({"candidates": [list(x) for x in c]})
        return c

    jt._step_fn, jt._tokenize_full, jt._candidates = step_spy, tok_spy, cand_spy
    jout = jt.train_episode(max_steps=STEPS)

    tt = TTrainer(tp, tcfg, lambda: _feed(TFeed, tcfg), waypoint_params=twp,
                  depth_enc_params=tde, device="cpu")
    tout = tt.train_episode(max_steps=STEPS)
    # the spies append (candidates) then (gt, loss) per step
    jsteps = [dict(jlog[2 * i], **jlog[2 * i + 1]) for i in range(len(jlog) // 2)]
    return jout, jsteps, tout, tt


def test_same_steps_and_gt_texts(episodes):
    jout, jsteps, tout, tt = episodes
    assert tout["steps"] == jout["steps"] == len(jsteps) == len(tt.step_log) >= 2
    assert [s["gt"] for s in tt.step_log] == [s["gt"] for s in jsteps]


def test_candidates_come_from_the_predictor_and_match(episodes):
    _, jsteps, _, tt = episodes
    for t, j in zip(tt.step_log, jsteps):
        assert t["from_predictor"]
        assert 1 <= len(t["candidates"][0]) <= 5
        # the same picks: distances exactly; angles (3-degree bins) within
        # an f32 ulp, as XLA folds 2 pi / 120 into one constant
        np.testing.assert_array_equal(np.float32(t["candidates"][1]), np.float32(j["candidates"][1]))
        np.testing.assert_allclose(t["candidates"][0], j["candidates"][0], rtol=1e-6)


def test_losses_per_step_match(episodes):
    jout, jsteps, tout, tt = episodes
    for t, j in zip(tt.step_log, jsteps):
        assert not t["skipped"] and np.isfinite(t["grad_norm"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-4)
    assert tt.logs["IL_loss"] == [tout["loss"]]


def test_every_trainable_tree_moved_and_frozen_did_not(episodes):
    *_, tt = episodes
    fresh = to_torch(jpolicy.init_policy_params(jax.random.PRNGKey(0), slice_config(),
                                                llm_dtype=jnp.float32))
    p = tt.params()
    for k in ("patch_pos_emb", "inst_pos_emb", "zone_pos_emb", "inst_proj", "zone_proj"):
        assert not np.array_equal(p[k]["fc2"]["w"].numpy(), fresh[k]["fc2"]["w"].numpy()), k
    assert not np.array_equal(p["llava"]["phi3"]["lm_head"].numpy(),
                              fresh["llava"]["phi3"]["lm_head"].numpy())
    for k in ("fields", "clip"):
        for a, b in zip(jax.tree_util.tree_leaves(p[k]), jax.tree_util.tree_leaves(fresh[k])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(p["llava"]["projector"]["fc1"]["w"].numpy(),
                                  fresh["llava"]["projector"]["fc1"]["w"].numpy())
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(p))
