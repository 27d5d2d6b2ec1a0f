"""Port parity of the 3DFF pretraining pieces: the losses
(``runtime/losses_3dff.py``), the pretraining memory update
(``models/memory3d/pretrain.py``), the gradients of one
``pretrain_step_loss`` (``runtime/trainer_3dff.py``) and the dataset draw.

Encoders run float32 (``encoder_dtype="f32"``) where the point is the
algorithm.  Tolerances: losses 1e-6; memory tables and aux exact for ids
and masks, 1e-4 for values; the step loss 1e-5 relative; every gradient
leaf of ``fields`` within 1e-4 of its scale.  The ``render`` leaves sit
behind the NeRF MLP, whose backward rounds each cotangent to bf16 after a
float32 dot: there the bound is one bf16 step of the leaf's scale (2**-7)
and 5e-3 in norm, as an order-dependent rounding may land a step apart."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import Dynam3DConfig, FieldsConfig
from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.models.memory3d.pretrain import update_view_pretrain as j_uvp
from dynam3d_tpu.models.segmenter import depth_plane_segments
from dynam3d_tpu.runtime import losses_3dff as jloss
from dynam3d_tpu.runtime import trainer_3dff as jtr
from dynam3d_torch.models import memory3d as tm
from dynam3d_torch.models.memory3d.pretrain import update_view_pretrain as t_uvp
from dynam3d_torch.runtime import losses_3dff as tloss
from dynam3d_torch.runtime import trainer_3dff as ttr
from tests.test_pretrain import FCFG, batch_and_params  # noqa: F401  (fixture)
from tests.test_torch_memory3d import _compare
from tests.torch_parity import np32, port_config, to_torch


def batch_to_torch(batch):
    """A reference ``PretrainBatch`` -> the port's (int32 -> int64)."""
    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a.astype(np.float32) if a.dtype.name == "bfloat16" else a))
        return t.to(torch.int64) if t.dtype == torch.int32 else t

    return ttr.PretrainBatch(*(conv(a) for a in batch))


# --- losses ----------------------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(12, 8)).astype(np.float32)
    b = rng.normal(size=(12, 8)).astype(np.float32)
    m = rng.uniform(size=12) > 0.3
    logits = rng.normal(size=(40, 6)).astype(np.float32) * 3
    tgt = rng.integers(-1, 6, 40).astype(np.int32)
    fm = rng.uniform(size=40) > 0.2
    margin = rng.normal(size=30).astype(np.float32) * 4
    mt = rng.integers(0, 2, 30).astype(np.int32)
    mv = rng.uniform(size=30) > 0.25
    return dict(
        cosine=((a, b, m), "cosine_loss"),
        subspace=((a, b, a.mean(0), b.mean(0), m), "subspace_cosine_loss"),
        contrastive=((a, b, m), "contrastive_loss"),
        contrastive_none=((a, b, np.zeros(12, bool)), "contrastive_loss"),
        focal=((logits, tgt, fm), "focal_loss"),
        focal_none=((logits, tgt, np.zeros(40, bool)), "focal_loss"),
        merge=((margin, mt, mv), "balanced_merge_ce"),
        merge_one_class=((margin, np.ones(30, np.int32), mv), "balanced_merge_ce"),
    )


@pytest.mark.parametrize("case", list(_loss_inputs()))
def test_loss_matches_reference(case):
    args, name = _loss_inputs()[case]
    want = float(getattr(jloss, name)(*(jnp.asarray(a) for a in args)))
    got = float(getattr(tloss, name)(*(torch.from_numpy(np.asarray(a)) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --- pretraining memory update ---------------------------------------------

def _fields():
    return FieldsConfig(input_height=4, input_width=4, fts_dim=64, patch_capacity=256,
                        instance_capacity=64, zone_capacity=32, max_segments=8, max_members=32,
                        max_zone_members=16, encoder_dtype="f32")


def _view(rng, v):
    d = np.repeat(rng.uniform(1.0, 4.0, (2, 1)), 8, axis=1).reshape(-1)
    d = (d + rng.normal(scale=0.02, size=16)).astype(np.float32)
    grid = rng.normal(size=(16, 64)).astype(np.float32)
    return d, grid, np.float32([0.3 * v, -0.2 * v, 1.25]), np.float32(0.4 * v)


def test_update_view_pretrain_after_one_and_two_views():
    jcfg = _fields()
    tcfg = port_config(Dynam3DConfig(fields=jcfg)).fields
    jp = jm.init_field_params(jax.random.PRNGKey(4), jcfg)
    tp = to_torch(jp)
    js = jm.init_state(jcfg, fts_dtype=jnp.float32)
    ts = tm.init_state(tcfg, "cpu", fts_dtype=torch.float32)
    rng = np.random.default_rng(11)
    gt_xyz = rng.uniform(-4, 4, (48, 3)).astype(np.float32)
    gt_label = rng.integers(1, 20, 48).astype(np.int32)
    gt_valid = rng.uniform(size=48) > 0.1
    upd = jax.jit(lambda p, s, d, g, sg, pos, h: j_uvp(p, s, jcfg, d, g, sg, pos, h,
                                                       jnp.asarray(gt_xyz), jnp.asarray(gt_label),
                                                       jnp.asarray(gt_valid), 20))
    merges = 0
    for v in range(2):
        d, grid, pos, hd = _view(rng, v)
        segm = np.array(depth_plane_segments(jnp.asarray(d), 4, 4, 8))
        js, jaux = upd(jp, js, jnp.asarray(d), jnp.asarray(grid), jnp.asarray(segm),
                       jnp.asarray(pos), jnp.float32(hd))
        ts, taux = t_uvp(tp, ts, tcfg, torch.from_numpy(d), torch.from_numpy(grid),
                         torch.from_numpy(segm), torch.from_numpy(pos), torch.tensor(hd),
                         torch.from_numpy(gt_xyz), torch.from_numpy(gt_label),
                         torch.from_numpy(gt_valid), 20)
        _compare(ts, js)
        for name in jaux._fields:
            if name == "base":
                pairs = [(f"base.{n}", getattr(taux.base, n), getattr(jaux.base, n))
                         for n in jaux.base._fields]
            else:
                pairs = [(name, getattr(taux, name), getattr(jaux, name))]
            for label, a, b in pairs:
                b = np.asarray(b)
                if b.dtype.kind in "biu":
                    np.testing.assert_array_equal(a.numpy(), b, err_msg=label)
                else:
                    np.testing.assert_allclose(np32(a), np32(b), rtol=1e-4, atol=1e-4,
                                               err_msg=label)
        merges += int(taux.base.is_merge.sum())
    assert merges >= 1
    gt = ts.inst_gt_id[ts.inst_valid]
    assert (gt >= 0).any()


# --- one step's loss and gradients -------------------------------------------

def _f32(cfg):
    return dataclasses.replace(cfg, encoder_dtype="f32")


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{pre}/{i}")]
    return [pre]


def _jax_paths(tree):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/" + "/".join(key(k) for k in kp): v for kp, v in flat}


def test_pretrain_step_loss_gradients_match_reference(batch_and_params):
    params, batch = batch_and_params
    jcfg = Dynam3DConfig(fields=_f32(FCFG))
    tcfg = port_config(jcfg)
    jloss_v, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.pretrain_step_loss(p, jcfg, jm.init_state(jcfg.fields), batch, 32)[0]
    ))(params)
    tparams = to_torch(params)
    leaves = [p.requires_grad_(True) for p in ttr.tree_leaves(tparams)]
    tloss_v, tstate, _ = ttr.pretrain_step_loss(tparams, tcfg, tm.init_state(tcfg.fields, "cpu"),
                                                batch_to_torch(batch), 32)
    grads = torch.autograd.grad(tloss_v, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tloss_v.detach()), float(jloss_v), rtol=1e-5)
    assert int(tstate.inst_valid.sum()) > 0
    want = _jax_paths(jgrads)
    names = _paths(tparams)
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        ref = np32(want[name])
        got = np.zeros_like(ref) if g is None else np32(g)
        scale = max(float(np.abs(ref).max()), 1e-12)
        err = np.abs(got - ref).max()
        if name.startswith("/render"):
            assert err <= 2.0 ** -7 * scale, name
            assert np.linalg.norm(got - ref) <= 5e-3 * max(np.linalg.norm(ref), 1e-12), name
        else:
            assert err <= 1e-4 * scale, (name, err, scale)


# --- the host-agreed dataset draw -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_draw_dataset_id_matches_reference(seed):
    its = jnp.arange(64)
    for n in range(1, 6):
        want = np.asarray(jax.vmap(lambda i: jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(seed), i), (), 0, n))(its))
        got = [ttr.draw_dataset_id(seed, i, n) for i in range(64)]
        np.testing.assert_array_equal(got, want)
