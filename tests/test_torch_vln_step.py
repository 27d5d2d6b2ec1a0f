"""One whole IL step through the port and the JAX package, and the port's
Adafactor against ``optax.adafactor``.

* The optimizer alone: three in-place updates on the same float32
  gradients, unscaled and scaled by 0.5, over a factored leaf ([130, 256]:
  both dims >= 128), a factored 3-D leaf, a leaf with one dim below 128
  and a vector; updates and second moments within 1e-6 relative (``**
  -0.5`` against XLA's rsqrt, one ulp), plus one f32 ulp of the parameter
  for the update read back from the parameter.
* The step: ``make_train_step`` (jitted, lr 1e-3) against the port's on the
  same weights and batch (tiny slice config, float32).  Loss and global
  norm within 1e-4 relative; the updated trainable leaves: the update of
  a first Adafactor step is ``sign(g) * lr * rms(p)`` (second moment =
  g^2), so an element whose gradient is near zero on either side may take
  the other sign.  Elements agree within 1e-4 of the update's size, but
  for at most 0.1% of a leaf, where the two updates have opposite signs
  (none here).
* A NaN loss: both leave every parameter and the optimizer state as they
  were, and both report the step as skipped.
* bf16 weights: an update below half a bf16 step rounds away, as in
  ``optax.apply_updates``.
"""

import dataclasses

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.runtime import trainer_vln as jtv
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_tpu.runtime.vln_loop import VLNTrainer as JTrainer
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime import trainer_vln as ttv
from dynam3d_torch.runtime.vln_loop import VLNTrainer as TTrainer
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from dynam3d_torch.utils.tree import tree_leaves
from tests.test_torch_pretrain import _jax_paths, _paths
from tests.torch_parity import np32, port_config, slice_config, to_torch

GT = "turn right 3 steps, move 2 steps.<|end|>"
SHAPES = {"a": (130, 256), "b": (7,), "c": (3, 200), "d": (2, 256, 130)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("grad_scale", [1.0, 0.5])
def test_adafactor_matches_optax_over_three_updates(grad_scale):
    """``step_`` (the in-place update training runs) against ``optax.adafactor``
    on the gradients times ``grad_scale``: the parameters' change within 1e-6
    relative plus one f32 ulp of the parameter (the add's rounding), the
    second moments within 1e-6 relative."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.05)
    jopt = optax.adafactor(learning_rate=1e-2)
    jstate = jopt.init(params)
    topt = ttv.Adafactor(1e-2)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tparams)
    assert tuple(tstate["v_row"]["a"].shape) == (130,) and tuple(tstate["v_col"]["a"].shape) == (256,)
    assert tuple(tstate["v_row"]["d"].shape) == (2, 130)
    assert tuple(tstate["v"]["c"].shape) == (3, 200)
    jparams = params
    for it in range(3):
        grads = _tree(rng)
        ju, jstate = jopt.update({k: g * np.float32(grad_scale) for k, g in grads.items()},
                                 jstate, jparams)
        jnew = optax.apply_updates(jparams, ju)
        old = {k: v.numpy().copy() for k, v in tparams.items()}
        topt.step_(tree_leaves({k: torch.from_numpy(v) for k, v in grads.items()}), tstate,
                   tparams, grad_scale=grad_scale)
        assert tstate["count"] == int(jstate[0].count) == it + 1
        for k in SHAPES:
            ulp = np.spacing(np.abs(old[k])).max()
            np.testing.assert_allclose(tparams[k].numpy() - old[k],
                                       np.asarray(jnew[k]) - np.asarray(jparams[k]),
                                       rtol=1e-6, atol=ulp, err_msg=f"update {k} at {it}")
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jnew[k]), rtol=1e-6,
                                       atol=1e-9)
            for name in ("v_row", "v_col", "v"):
                np.testing.assert_allclose(tstate[name][k].numpy(),
                                           np.asarray(getattr(jstate[0], name)[k]),
                                           rtol=1e-6, err_msg=f"{name} {k} at {it}")
        jparams = jnew


def test_bf16_updates_round_away_as_in_optax():
    p = np.float32([0.02, -0.5, 1.0, 3e-7])
    u = np.float32([1e-8, -1e-6, 1e-5, 1e-8])
    jp = jnp.asarray(p, jnp.bfloat16)
    ref = np.asarray(optax.apply_updates(jp, jnp.asarray(u)), np.float32)
    got = ttv.apply_update(torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(u))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(got.float().numpy()[:3], np.asarray(jp, np.float32)[:3])


@pytest.fixture(scope="module")
def steps():
    jcfg = slice_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, lr=1e-3, use_waypoint_predictor=False))
    tcfg = port_config(jcfg)
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    tp = to_torch(jp)
    jt = JTrainer(jp, jcfg, lambda: None)
    tt = TTrainer(tp, tcfg, lambda: None, device="cpu")
    obs = JFeed(rgb_size=56, depth_size=32, views=1, seed=2).reset()
    hist = ["none\n", "none\n", "move 2 steps.\n", "turn left 1 steps, move 1 steps.\n"]
    jtok = [np.asarray(a) for a in jt._tokenize_full(obs.instruction, hist, GT)]
    ttok = [t.numpy() for t in tt._tokenize_full(obs.instruction, hist, GT)]

    def jbatch(tw):
        ids, tv, lab, lm = jtok
        return jtv.TrainBatch(rgb=jnp.asarray(obs.rgb[None]), depth=jnp.asarray(obs.depth[None]),
                              position=jnp.asarray(np.float32(obs.position)[None]),
                              heading=jnp.asarray(np.float32([obs.heading])),
                              input_ids=jnp.asarray(ids), text_valid=jnp.asarray(tv),
                              label_ids=jnp.asarray(lab), label_mask=jnp.asarray(lm),
                              turn_weight=jnp.asarray(np.float32([tw])))

    def tbatch(tw):
        ids, tv, lab, lm = (torch.from_numpy(a) for a in ttok)
        return ttv.TrainBatch(rgb=torch.from_numpy(obs.rgb[None]),
                              depth=torch.from_numpy(obs.depth[None]),
                              position=torch.from_numpy(np.float32(obs.position)[None]),
                              heading=torch.tensor([obs.heading], dtype=torch.float32),
                              input_ids=ids, text_valid=tv, label_ids=lab, label_mask=lm,
                              turn_weight=torch.tensor([tw], dtype=torch.float32))

    jstep = jax.jit(jtv.make_train_step(jcfg, jt.optimizer, jt.splice_start))
    jtr0 = _jax_paths(jax.tree_util.tree_map(np.array, jt.trainable))
    jopt0 = jax.tree_util.tree_map(np.array, jt.opt_state)
    state0 = jpolicy.batched_init_state(jcfg, 1)
    names = _paths(tt.trainable)
    out = {"tok": (jtok, ttok), "jtr0": jtr0, "jopt0": jopt0}
    for name, tw in (("nan", float("nan")), ("step", 1.0)):
        jtr, jopt, jst, jm = jstep(jt.trainable, jt.frozen, jt.opt_state, state0, jbatch(tw))
        ttr0 = dict(zip(names, (t.clone() for t in tree_leaves(tt.trainable))))
        _, topt, tst, tm = tt._step_fn(tt.trainable, tt.frozen, tt.opt_state,
                                       tpolicy.batched_init_state(tcfg, 1, "cpu"), tbatch(tw))
        ttr = dict(zip(names, (t.clone() for t in tree_leaves(tt.trainable))))
        out[name] = dict(jtr=_jax_paths(jtr), jopt=jopt, jst=jst, jm=jm, ttr0=ttr0, ttr=ttr,
                         count=topt["count"], tst=tst, tm=tm,
                         v_sum=sum(float(t.abs().sum()) for t in tree_leaves(
                             [topt["v_row"], topt["v_col"], topt["v"]])))
    return out


def test_tokenized_batches_match(steps):
    jtok, ttok = steps["tok"]
    for j, t in zip(jtok, ttok):
        np.testing.assert_array_equal(t, j)
    assert ttok[0].shape[1] % 64 == 0 and ttok[2].shape[1] % 16 == 0 and ttok[3].sum() == len(GT) - 6


def test_step_loss_norm_and_memory_match(steps):
    s = steps["step"]
    assert not s["tm"]["skipped"] and not bool(s["jm"]["skipped"])
    np.testing.assert_allclose(float(s["tm"]["loss"]), float(s["jm"]["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(s["tm"]["grad_norm"]), float(s["jm"]["grad_norm"]),
                               rtol=1e-4)
    for name in ("patch_valid", "inst_valid", "zone_valid"):
        np.testing.assert_array_equal(np32(getattr(s["tst"], name)),
                                      np32(getattr(s["jst"], name)), err_msg=name)
    assert s["count"] == int(s["jopt"][0].count) == 1


def test_step_updates_every_trainable_leaf_alike(steps):
    s, jtr0 = steps["step"], steps["jtr0"]
    assert sorted(jtr0) == sorted(s["jtr"]) == sorted(s["ttr"])
    for name, p0 in jtr0.items():
        np.testing.assert_array_equal(s["ttr0"][name].numpy(), p0)
        ju = np.asarray(s["jtr"][name], np.float64) - p0
        tu = s["ttr"][name].numpy().astype(np.float64) - p0
        assert np.abs(ju).max() > 0 and np.abs(tu).max() > 0, name
        size = np.abs(ju).max()
        flipped = np.sign(ju) * np.sign(tu) < 0
        assert flipped.mean() <= 0.001, (name, flipped.mean())
        np.testing.assert_allclose(tu[~flipped], ju[~flipped], rtol=0, atol=1e-4 * size,
                                   err_msg=name)


def test_nan_loss_skips_the_update_in_both(steps):
    s = steps["nan"]
    assert np.isnan(float(s["tm"]["loss"])) and np.isnan(float(s["jm"]["loss"]))
    assert s["tm"]["skipped"] and bool(s["jm"]["skipped"])
    for name, p0 in steps["jtr0"].items():
        np.testing.assert_array_equal(np.asarray(s["jtr"][name]), p0)
        np.testing.assert_array_equal(s["ttr"][name].numpy(), s["ttr0"][name].numpy())
    assert s["count"] == int(s["jopt"][0].count) == 0 and s["v_sum"] == 0.0
    zero = jax.tree_util.tree_leaves(steps["jopt0"])
    for a, b in zip(jax.tree_util.tree_leaves(s["jopt"]), zero):
        np.testing.assert_array_equal(np.asarray(a), b)
