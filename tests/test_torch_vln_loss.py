"""The IL loss through the port and the JAX package on the same converted
weights (tiny slice config, float32 Phi-3): ``teacher_forced_loss`` on
given embeddings, and ``perceive`` + ``train_loss`` of one teacher-forced
step with its gradient on every trainable leaf against
``jax.value_and_grad``.

Losses within 1e-5 relative where the embeddings are given, 1e-4 through
perception (float32 towers and aggregation summed in another order: 1e-3
on the multimodal tokens, ``test_torch_perceive.py``).  Gradients within
2e-3 of each leaf's largest gradient."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.models.vlm import llava as jllava
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_tpu.runtime import trainer_vln as jtv
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_tpu.runtime.vln_loop import VLNTrainer as JTrainer
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.models.vlm import llava as tllava
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.runtime import trainer_vln as ttv
from dynam3d_torch.utils.tree import tree_leaves
from tests.test_torch_pretrain import _jax_paths, _paths
from tests.torch_parity import np32, port_config, slice_config, to_torch

GT = "turn left 2 steps, move 3 steps.<|end|>"


@pytest.fixture(scope="module")
def setup():
    jcfg = slice_config()
    jcfg = dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, use_waypoint_predictor=False))
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    return jcfg, port_config(jcfg), jp


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("prompt_len", [40, 60])
def test_teacher_forced_loss_matches(setup, prompt_len):
    """Given embeddings; ``prompt_len`` 60 runs the label rows past T = 64,
    where both clip the gather to the last position."""
    jcfg, tcfg, jp = setup
    rng = np.random.default_rng(prompt_len)
    B, T, Tg, D = 2, 64, 16, jcfg.llava.phi3.hidden_size
    emb = rng.standard_normal((B, T, D)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 50:] = False
    valid[0, 5:9] = False
    labels = rng.integers(0, 256, (B, Tg)).astype(np.int32)
    lmask = np.zeros((B, Tg), bool)
    lmask[0, :9] = True
    lmask[1, :3] = True
    plen = np.int32([prompt_len, prompt_len - 20])
    tw = np.float32([1.0, 0.0])
    jout = jllava.teacher_forced_loss(jp["llava"], jcfg.llava, emb, valid, labels, lmask,
                                      plen, tw)
    tp = to_torch(jp)
    tout = tllava.teacher_forced_loss(tp["llava"], tcfg.llava, _t(emb), _t(valid),
                                      _t(labels, torch.int64), _t(lmask),
                                      _t(plen, torch.int64), _t(tw))
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), rtol=1e-5)
    np.testing.assert_allclose(np32(tout.logits_at_labels), np32(jout.logits_at_labels),
                               rtol=1e-4, atol=1e-4)


def test_training_forward_matches_the_cache_forward(setup):
    """``forward_train`` (own K/V, per-layer checkpoint, gathered lm_head
    rows) gives the logits of ``forward`` on a fresh cache at the same rows,
    and the same gradients gathering 3 rows as gathering all T and
    indexing those 3."""
    jcfg, tcfg, jp = setup
    p3 = tcfg.llava.phi3
    tp = to_torch(jp)["llava"]["phi3"]
    rng = np.random.default_rng(1)
    T = 32
    emb = _t(rng.standard_normal((1, T, p3.hidden_size)).astype(np.float32))
    valid = torch.ones(1, T, dtype=torch.bool)
    valid[0, 3:6] = False
    pos = torch.clamp(torch.cumsum(valid.long(), 1) - 1, min=0)
    mask = tphi3.prefill_mask(valid, T)
    full, _ = tphi3.forward(tp, p3, emb, pos, tphi3.init_cache(p3, 1, T, torch.float32, "cpu"),
                            0, mask)
    rows = torch.tensor([[7, 20, 31]])
    w = tp["lm_head"].requires_grad_(True)
    sel = tphi3.forward_train(tp, p3, emb, pos, mask, lm_rows=rows)
    g_sel, = torch.autograd.grad(sel.sum(), w)
    ref = tphi3.forward_train(tp, p3, emb, pos, mask, lm_rows=torch.arange(T)[None])[:, rows[0]]
    g_ref, = torch.autograd.grad(ref.sum(), w)
    w.requires_grad_(False)
    np.testing.assert_allclose(np32(sel), np32(full[:, rows[0]]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np32(g_sel), np32(g_ref), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def step_grads(setup):
    """One teacher-forced step's loss and gradients in both packages."""
    jcfg, tcfg, jp = setup
    jt = JTrainer(jp, jcfg, lambda: None)
    obs = JFeed(rgb_size=56, depth_size=32, views=1, seed=2).reset()
    ids, tv, lab, lm = (np.asarray(a) for a in jt._tokenize_full(obs.instruction,
                                                                  ["none\n"] * 4, GT))
    batch = dict(rgb=obs.rgb[None], depth=obs.depth[None],
                 position=np.float32(obs.position)[None], heading=np.float32([obs.heading]),
                 ids=ids, tv=tv, lab=lab, lm=lm, tw=np.float32([1.0]))
    trainable, frozen = jtv.split_params(jp)
    state0 = jpolicy.batched_init_state(jcfg, 1)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        p = jtv.merge_params(tr, frozen)
        out = jpolicy.perceive(p, jcfg, state0, jb["rgb"], jb["depth"], jb["position"],
                               jb["heading"])
        return jpolicy.train_loss(p, jcfg, jb["ids"], jb["tv"], out.mm_tokens, out.mm_valid,
                                  jb["lab"], jb["lm"], jb["tw"], jt.splice_start).loss

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(trainable)

    tp = to_torch(jp)
    ttr, tfr = ttv.split_params(tp)
    leaves = tree_leaves(ttr)
    for t in leaves:
        t.requires_grad_(True)
    p = ttv.merge_params(ttr, tfr)
    out = tpolicy.perceive(p, tcfg, tpolicy.batched_init_state(tcfg, 1, "cpu"),
                           _t(batch["rgb"]), _t(batch["depth"]), _t(batch["position"]),
                           _t(batch["heading"]))
    tl = tpolicy.train_loss(p, tcfg, _t(ids, torch.int64), _t(tv), out.mm_tokens, out.mm_valid,
                            _t(lab, torch.int64), _t(lm), _t(batch["tw"]), jt.splice_start)
    tgrads = dict(zip(_paths(ttr), torch.autograd.grad(tl.loss, leaves)))
    return float(jloss), _jax_paths(jgrads), float(tl.loss.detach()), tgrads, out


def test_step_loss_matches(step_grads):
    jloss, _, tloss, _, _ = step_grads
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


@pytest.mark.parametrize("group", ["projectors", "phi3"])
def test_gradients_on_every_trainable_leaf(step_grads, group):
    """The five projector trees (6 leaves each) and every Phi-3 leaf."""
    _, jg, _, tg, _ = step_grads
    assert sorted(jg) == sorted(tg)
    names = [n for n in tg if n.startswith("/phi3/") == (group == "phi3")]
    assert len(names) == (30 if group == "projectors" else len(tg) - 30)
    for name in names:
        j, t = np.asarray(jg[name]), np32(tg[name])
        assert j.shape == t.shape and np.abs(j).max() > 0, name
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-3 * np.abs(j).max(), err_msg=name)


def test_perceive_in_the_step_records_no_memory_update(step_grads):
    *_, out = step_grads
    assert not any(t.requires_grad for t in out.state)
    assert out.mm_tokens.requires_grad
