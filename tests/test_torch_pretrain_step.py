"""Port parity of one training update (``make_pretrain_step``): gradients
of the step loss, NaN scrub, per-value clip and AdamW (weight decay 1e-4,
the reference optimizer's default), on the reference's test batch with
float32 encoders.  The parameters after the step within 1e-6, the optimizer
moments within 2e-4 of their scale (the
gradients' 1e-4, squared in ``nu``), the metrics within 1e-5 relative.

One exception: the key third of every attention ``qkv`` bias has a zero
gradient in exact arithmetic (a softmax ignores a constant added to every
key of a query), so both sides hold float noise there (~1e-9) that Adam's
first step divides by its own magnitude; those entries move by up to the
learning rate either way and are held to 2e-5."""

import dataclasses

import numpy as np
import jax
import torch

from dynam3d_tpu.config import Dynam3DConfig
from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.runtime import trainer_3dff as jtr
from dynam3d_torch.models import memory3d as tm
from dynam3d_torch.runtime import trainer_3dff as ttr
from tests.test_pretrain import FCFG, batch_and_params  # noqa: F401  (fixture)
from tests.test_torch_pretrain import _jax_paths, _paths, batch_to_torch
from tests.torch_parity import np32, port_config, to_torch


def test_one_update_matches_reference(batch_and_params):
    params, batch = batch_and_params
    jcfg = Dynam3DConfig(fields=dataclasses.replace(FCFG, encoder_dtype="f32"))
    tcfg = port_config(jcfg)
    jopt = jtr.make_pretrain_optimizer(jcfg)
    jstep = jax.jit(jtr.make_pretrain_step(jcfg, jopt))
    jnew, jopt_state, _, jm_ = jstep(params, jopt.init(params), jm.init_state(jcfg.fields), batch)

    tparams = to_torch(params)
    topt = ttr.make_pretrain_optimizer(tcfg)
    assert (topt.lr, topt.clip, topt.wd) == (1e-5, 10.0, 1e-4)
    tstep = ttr.make_pretrain_step(tcfg, topt)
    tnew, topt_state, _, tm_ = tstep(tparams, topt.init(tparams),
                                     tm.init_state(tcfg.fields, "cpu"), batch_to_torch(batch))

    assert not bool(tm_["skipped"]) and not bool(jm_["skipped"])
    assert sorted(tm_) == sorted(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want, before = _jax_paths(jnew), _jax_paths(params)
    moved = 0.0
    D = FCFG.fts_dim
    for name, a in zip(_paths(tnew), ttr.tree_leaves(tnew)):
        got, ref = np32(a), np32(want[name])
        tol = np.full(ref.shape, 1e-6, np.float32)
        if name.endswith("attn/qkv/b"):
            tol[D:2 * D] = 2e-5
        assert (np.abs(got - ref) <= tol).all(), name
        moved += float(np.abs(got - np32(before[name])).sum())
    assert moved > 0
    # optax's adam state is (count, mu, nu) after the clip's empty state
    adam = jopt_state[1][0]
    assert int(adam.count) == topt_state["count"] == 1
    for name, jt in (("mu", adam.mu), ("nu", adam.nu)):
        for a, b in zip(topt_state[name], jax.tree_util.tree_leaves(jt)):
            ref = np32(b)
            assert np.abs(np32(a) - ref).max() <= 2e-4 * max(np.abs(ref).max(), 1e-12), name


def test_nan_loss_keeps_parameters_and_advances_the_optimizer(monkeypatch):
    """A NaN loss skips the parameter update; NaN gradients read as zero and
    the optimizer count and moments still advance (the reference's skip)."""
    def nan_loss(params, cfg, state, batch, posed=False):
        w = params["fields"]["w"]
        loss = (w * torch.tensor([1.0, float("nan"), 20.0])).sum() * float("nan")
        return loss, state, {"sim_loss": loss}

    monkeypatch.setattr(ttr, "pretrain_step_loss", nan_loss)
    cfg = port_config(Dynam3DConfig())
    opt = ttr.make_pretrain_optimizer(cfg)
    params = {"fields": {"w": torch.ones(3)}, "render": {"b": torch.zeros(2)}}
    step = ttr.make_pretrain_step(cfg, opt)
    new, state, _, metrics = step(params, opt.init(params), tm.init_state(cfg.fields, "cpu"), None)
    assert bool(metrics["skipped"])
    assert new["fields"]["w"] is params["fields"]["w"]
    assert state["count"] == 1
    assert all(float(m.abs().sum()) == 0.0 for m in state["mu"])     # NaN grads -> 0
