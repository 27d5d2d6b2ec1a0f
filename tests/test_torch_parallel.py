"""The port's parallel layer against the JAX package at
``tests/test_parallel.py``'s ``TINY`` Phi-3 (float32), tensor-parallel over
two gloo ranks on the CPU (``tests/torch_dist.py::tp_phi3``, one spawn for
the whole file):

* ``split_qkv_params`` and ``phi3_param_specs`` equal to JAX's, leaf for
  leaf (a spec's ``PartitionSpec`` over ``"tp"`` is the port's shard dim);
  the split layout's forward equal to the fused one in both packages;
* TP = 2 ``greedy_decode``: ids identical to the JAX single-device
  ``greedy_decode``; exactly two all-reduces a layer a pass (the port's
  counted collectives; the twin of ``test_tp_comm_volume_is_megatron_minimal``),
  one embedding all-reduce and one logits gather a pass, nothing else;
* TP = 2 ``teacher_forced_loss``: the loss within 1e-5 relative and every
  gradient within 2e-3 of its leaf's largest (the one-process tolerances of
  ``test_torch_vln_loss.py``) of ``jax.value_and_grad`` on one device, the
  backward's all-reduces (one a column-parallel input) counted;
* Adafactor over leaves sharded on either dim of a factored matrix and on a
  vector, three updates: the whole leaves within 1e-6 relative (plus one f32
  ulp) of one process's updates;
* the fused decode kernels ineligible under TP; a TP checkpoint (unsharded
  by rank 0) loads into one process and shards back exactly.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import LLaVAConfig as JLLaVAConfig
from dynam3d_tpu.config import Phi3Config as JPhi3Config
from dynam3d_tpu.models.vlm import llava as jllava
from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_tpu.parallel import mesh as jmesh
from dynam3d_torch.config import Phi3Config
from dynam3d_torch.models.vlm import phi3 as tphi3
from dynam3d_torch.parallel import mesh as tmesh
from dynam3d_torch.parallel.spawn import run_ranks
from dynam3d_torch.runtime import checkpoint as ckpt_mod
from dynam3d_torch.runtime.trainer_vln import Adafactor
from dynam3d_torch.utils.tree import tree_leaves, tree_map
from tests import torch_dist
from tests.torch_parity import np32

# tests/test_parallel.py's TINY
JTINY = JPhi3Config(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                    num_heads=4, num_kv_heads=4, head_dim=16, pad_token_id=0, end_token_id=1)
TINY = Phi3Config(**dataclasses.asdict(JTINY))
OPT_SHAPES = {"a": ((256, 260), 0), "b": ((256, 260), 1), "c": ((260, 256), 0), "v": ((8,), 0)}


def tree_map_np(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jspec(s):
    """A JAX PartitionSpec over 'tp' as the port's shard dim."""
    return None if len(s) == 0 or all(a is None for a in s) else list(s).index("tp")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jp = jphi3.init_phi3_params(jax.random.PRNGKey(0), JTINY, dtype=jnp.float32)
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 200, (1, 12))
    valid = np.ones((1, 12), bool)
    B, T, Tg, D = 2, 32, 8, JTINY.hidden_size
    emb = rng.standard_normal((B, T, D)).astype(np.float32)
    tvalid = np.ones((B, T), bool)
    tvalid[1, 26:] = False
    tvalid[0, 3:5] = False
    labels = rng.integers(0, 256, (B, Tg)).astype(np.int64)
    lmask = np.zeros((B, Tg), bool)
    lmask[0, :6] = True
    lmask[1, :3] = True
    plen = np.int64([20, 18])
    tw = np.float32([1.0, 0.0])
    train_in = (emb, tvalid, labels, lmask, plen, tw)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, (s, _) in OPT_SHAPES.items()}
    grad_sets = [{k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in
                  OPT_SHAPES.items()} for _ in range(3)]
    splits = [s for _, s in OPT_SHAPES.values()]
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    ranks = run_ranks(torch_dist.tp_phi3, 2, args=(p_np, TINY, (ids, valid, 5), train_in,
                                                   (params, grad_sets, splits), ckpt_dir),
                      timeout=240)
    return dict(jp=jp, p_np=p_np, ids=ids, valid=valid, train_in=train_in, params=params,
                grad_sets=grad_sets, ranks=ranks, ckpt_dir=ckpt_dir)


def test_split_and_specs_equal_the_reference(world):
    jsplit = jmesh.split_qkv_params(world["jp"], JTINY)
    tsplit = tmesh.split_qkv_params(tree_map_np(world["p_np"]), TINY)
    jl, jdef = jax.tree_util.tree_flatten_with_path(jsplit)
    assert len(jl) == len(tree_leaves(tsplit))
    for (path, a), b in zip(jl, _leaves_in_jax_order(jsplit, tsplit)):
        np.testing.assert_array_equal(np32(b), np.asarray(a), err_msg=str(path))
    jspecs = jmesh.phi3_param_specs(jsplit)
    tspecs = tmesh.phi3_param_specs(tsplit)
    assert tspecs["embed_tokens"] == _jspec(jspecs["embed_tokens"]) == 0
    assert tspecs["lm_head"] == _jspec(jspecs["lm_head"]) == 1
    assert tspecs["final_ln"] is None and _jspec(jspecs["final_ln"]) is None
    for jl_, tl_ in zip(jspecs["layers"], tspecs["layers"]):
        assert sorted(jl_) == sorted(tl_)
        assert {k: _jspec(v) for k, v in jl_.items()} == tl_
    assert tmesh.phi3_param_specs(tree_map_np(world["p_np"]))["layers"][0]["qkv"] == 1


def _leaves_in_jax_order(jtree, ttree):
    """The port tree's leaves in ``jax.tree_util``'s order (dict keys
    sorted), so the two flattenings pair up."""
    if isinstance(ttree, dict):
        return [x for k in sorted(ttree) for x in _leaves_in_jax_order(jtree[k], ttree[k])]
    if isinstance(ttree, (list, tuple)):
        return [x for j, t in zip(jtree, ttree) for x in _leaves_in_jax_order(j, t)]
    return [ttree]


def test_split_layout_forward_equals_the_fused_one(world):
    """One process: the split layout's logits equal the fused layout's in
    the port and in JAX, and the two packages agree."""
    fused = tree_map_np(world["p_np"])
    split = tmesh.split_qkv_params(fused, TINY)
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.standard_normal((1, 10, 64)).astype(np.float32))
    valid = torch.ones(1, 10, dtype=torch.bool)
    pos = torch.arange(10)[None]
    mask = tphi3.prefill_mask(valid, 10)
    outs = [tphi3.forward(p, TINY, emb, pos, tphi3.init_cache(TINY, 1, 10, torch.float32, "cpu"),
                          0, mask)[0] for p in (fused, split)]
    np.testing.assert_allclose(np32(outs[1]), np32(outs[0]), rtol=1e-5, atol=1e-5)
    jsplit = jmesh.split_qkv_params(world["jp"], JTINY)
    jcache = jphi3.init_cache(JTINY, 1, 10, dtype=jnp.float32)
    jout, _ = jphi3.forward(jsplit, JTINY, jnp.asarray(emb.numpy()), jnp.asarray(pos.numpy()),
                            jcache, 0, jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(np32(outs[1]), np.asarray(jout), rtol=1e-4, atol=1e-4)


def test_tp_decode_ids_equal_the_reference(world):
    ref = np.asarray(jphi3.greedy_decode(world["jp"], JTINY,
                                         jphi3.embed(world["jp"], jnp.asarray(world["ids"])),
                                         jnp.asarray(world["valid"]), 5))
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["ids"], ref)


def test_tp_collectives_are_megatron_minimal(world):
    """Per pass: 2 all-reduces a layer (after ``o`` and ``down``), one for
    the token embedding, one gather of the vocab-split logits; nothing
    else.  A 5-token decode is the prefill plus at least 2 decode passes."""
    for r in world["ranks"]:
        c = r["decode_counts"]
        passes = c["logits"]
        assert sorted(c) == ["embed", "layer", "logits"], c
        assert passes >= 3 and c["layer"] == 2 * TINY.num_layers * passes, c
        assert c["embed"] == passes, c
        f = r["train_forward_counts"]
        assert f == {"layer": 2 * TINY.num_layers, "logits": 1}, f
        b = r["train_counts"]
        # the per-layer checkpoint recomputes a layer up to the last tensor
        # its backward needs (one or both all-reduces, the same on every
        # rank); the gradient of each column-parallel input (q/k/v, gate/up,
        # lm_head) is summed once
        assert b["logits"] == 1 and b["backward"] == 2 * TINY.num_layers + 1, b
        assert 3 * TINY.num_layers <= b["layer"] <= 4 * TINY.num_layers, b
        assert sorted(b) == ["backward", "layer", "logits"], b
    assert world["ranks"][0]["train_counts"] == world["ranks"][1]["train_counts"]


def test_tp_training_gradients_equal_one_device(world):
    emb, tvalid, labels, lmask, plen, tw = world["train_in"]
    jsplit = jmesh.split_qkv_params(world["jp"], JTINY)
    jcfg = JLLaVAConfig(phi3=JTINY)

    def loss_fn(p, e):
        return jllava.teacher_forced_loss({"phi3": p}, jcfg, e, tvalid, labels.astype(np.int32),
                                          lmask, plen.astype(np.int32), tw).loss

    jloss, (jg, jge) = jax.value_and_grad(loss_fn, argnums=(0, 1))(jsplit, jnp.asarray(emb))
    for r in world["ranks"]:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        got = _leaves_in_jax_order(jg, r["grads"])
        for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0], got):
            j = np.asarray(j)
            np.testing.assert_allclose(t, j, rtol=0, atol=2e-3 * np.abs(j).max(),
                                       err_msg=str(path))
        jge = np.asarray(jge)
        np.testing.assert_allclose(r["emb_grad"], jge, rtol=0, atol=2e-3 * np.abs(jge).max())


def test_tp_adafactor_updates_equal_one_process(world):
    p = {k: torch.from_numpy(v.copy()) for k, v in world["params"].items()}
    opt = Adafactor(1e-2)
    st = opt.init(p)
    for gs in world["grad_sets"]:
        opt.step_([torch.from_numpy(gs[k]) for k in p], st, p)
    for r in world["ranks"]:
        for k, v in p.items():
            ulp = np.spacing(np.abs(v.numpy())).max()
            np.testing.assert_allclose(r["adafactor"][k], v.numpy(), rtol=1e-6, atol=ulp,
                                       err_msg=k)


def test_fused_kernels_ineligible_and_checkpoints_cross(world):
    for r in world["ranks"]:
        assert r["fused_eligible"] is False
        assert r["unshard_equal"] and r["reshard_equal"]
    split = tmesh.split_qkv_params(tree_map_np(world["p_np"]), TINY)
    loaded = ckpt_mod.load_checkpoint(ckpt_mod.newest_checkpoint(world["ckpt_dir"]))
    for a, b in zip(tree_leaves(loaded), tree_leaves(split)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unquantized"):
        tmesh.split_qkv_params(tphi3.quantize_phi3(tree_map_np(world["p_np"]), bits=4), TINY)
