"""Port parity of one walk step of 3DFF pretraining
(``runtime/trainer_3dff.py``): ``make_walk_grad_step`` over two steps of a
walk (the second from each package's own carried memory) against the JAX
package's, and ``apply_accumulated_grads`` against optax.

The walk tests' tiny config, float32 encoders and CLIP, bf16 memory
features as the walk keeps them.  Tolerances: the loss and every metric
1e-5 relative; the gradients as ``test_torch_pretrain.py`` holds them (every
``fields`` leaf within 1e-4 of its scale; ``render`` leaves, behind the NeRF
MLP's bf16 backward, within one bf16 step of their scale and 5e-3 in
norm); the accumulated update within 1e-7 of the reference's, and exact
where a NaN zeroed the gradient."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_tpu.runtime import trainer_3dff as jtr
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed
from dynam3d_torch.models import memory3d as tm
from dynam3d_torch.models.memory3d.state import stack_states
from dynam3d_torch.runtime import trainer_3dff as ttr
from dynam3d_torch.utils.tree import tree_leaves
from tests.test_torch_pretrain import _jax_paths, _paths
from tests.torch_parity import np32, port_config, to_torch, walk_config, walk_params


def _batches(D: int, R: int, nv: int = 2):
    """Two walk steps' inputs as numpy: panoramas of a feed along a short
    walk, novel cameras near the agent, random pooled targets."""
    feed = SyntheticRoomFeed(rgb_size=56, depth_size=64, views=12, seed=3)
    sup = jloop.synthetic_supervision(1, D)
    rng = np.random.default_rng(9)
    out, obs = [], feed.reset()
    for move in ((0.4, 1.0), None):
        nv_pos = np.stack([feed.get_cand_real_pos(float(a), 1.0)
                           for a in rng.uniform(-1, 1, nv)]).astype(np.float32)
        world = np.stack([nv_pos[:, 0], -nv_pos[:, 2], nv_pos[:, 1]], axis=-1)
        out.append(dict(
            rgb12=obs.rgb, depth12=obs.depth, position=obs.position,
            heading=np.float32(obs.heading), gt_xyz=sup["gt_xyz"], gt_label=sup["gt_label"],
            gt_valid=np.ones(sup["gt_xyz"].shape[0], bool), novel_position=world,
            novel_heading=rng.uniform(-np.pi, np.pi, nv).astype(np.float32),
            novel_gt_fts=rng.normal(size=(nv, R, D)).astype(np.float32),
            cat_embeddings=sup["cat_embeddings"], gtid_to_cat=sup["gtid_to_cat"],
            gtid_text_fts=sup["gtid_text_fts"], gtid_text_valid=sup["gtid_text_valid"],
            use_labels=np.bool_(True)))
        if move:
            obs, _, _ = feed.step(move)
    return out


def test_walk_grad_steps_match_reference():
    jcfg = walk_config()
    tcfg = port_config(jcfg)
    jp = walk_params(jcfg, 6)
    tp = to_torch(jp)
    f = jcfg.fields
    jtrain = {k: jp[k] for k in ("fields", "render")}
    jfrozen = {k: v for k, v in jp.items() if k not in jtrain}
    ttrain = {k: tp[k] for k in ("fields", "render")}
    tfrozen = {k: v for k, v in tp.items() if k not in ttrain}
    jstep = jax.jit(jtr.make_walk_grad_step(jcfg))
    tstep = ttr.make_walk_grad_step(tcfg)
    js = jax.tree_util.tree_map(lambda x: x[None], jm.init_state(f))
    ts = stack_states([tm.init_state(tcfg.fields, "cpu")])
    for b in _batches(f.fts_dim, f.view_height * f.view_width):
        jg, js, jmet = jstep(jtrain, jfrozen, js,
                             jtr.WalkBatch(**{k: jnp.asarray(v) for k, v in b.items()}))
        tg, ts, tmet = tstep(ttrain, tfrozen, ts,
                             ttr.WalkBatch(**{k: torch.from_numpy(np.asarray(v))
                                              for k, v in b.items()}))
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert not any(t.requires_grad for t in ts)
        want = _jax_paths(jg)
        names = _paths(tg)
        assert sorted(names) == sorted(want)
        for name, g in zip(names, tree_leaves(tg)):
            ref, got = np32(want[name]), np32(g)
            scale = max(float(np.abs(ref).max()), 1e-12)
            err = np.abs(got - ref).max()
            if name.startswith("/render"):
                assert err <= 2.0 ** -7 * scale, name
                assert np.linalg.norm(got - ref) <= 5e-3 * max(np.linalg.norm(ref), 1e-12), name
            else:
                assert err <= 1e-4 * scale, (name, err, scale)
    assert int(ts.inst_valid.sum()) > 0
    assert sum(float(np.abs(np32(g)).sum()) for g in tree_leaves(tg)) > 0


@pytest.mark.parametrize("n_steps", [3, 1])
def test_apply_accumulated_grads_matches_optax(n_steps):
    """Two episodes' updates of a small tree; one step's gradient of the
    first episode holds a NaN, which zeroes that element for the episode."""
    rng = np.random.default_rng(n_steps)
    shapes = {"fields": {"w": (5, 4), "b": (4,)}, "render": {"mlp": [(3, 3)]}}
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                    is_leaf=lambda s: isinstance(s, tuple))
    cfg = walk_config()
    jopt = jtr.make_pretrain_optimizer(cfg)
    topt = ttr.make_pretrain_optimizer(port_config(cfg))
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    ttree = to_torch(params)
    jstate, tstate = jopt.init(jtree), topt.init(ttree)
    for episode in range(2):
        steps = [jax.tree_util.tree_map(lambda p: (20 * rng.normal(size=p.shape)).astype(
            np.float32), params) for _ in range(n_steps)]
        if episode == 0:
            steps[-1]["fields"]["w"][1, 2] = np.nan
        gsum = jax.tree_util.tree_map(lambda *g: np.sum(np.stack(g), 0, dtype=np.float32),
                                      *steps)
        jtree, jstate = jtr.apply_accumulated_grads(
            jopt, jtree, jstate, jax.tree_util.tree_map(jnp.asarray, gsum), n_steps)
        ttree, tstate = ttr.apply_accumulated_grads(topt, ttree, tstate, to_torch(gsum), n_steps)
        for name, a in zip(_paths(ttree), tree_leaves(ttree)):
            np.testing.assert_allclose(np32(a), np32(_jax_paths(jtree)[name]), rtol=1e-7,
                                       atol=1e-7, err_msg=name)
        if episode == 0:
            # a zero gradient: the first Adam step leaves only the weight decay
            w0 = params["fields"]["w"][1, 2]
            assert float(ttree["fields"]["w"][1, 2]) == pytest.approx(
                w0 - cfg.train.pretrain_lr * 1e-4 * w0, abs=1e-12)
    assert tstate["count"] == 2
    np.testing.assert_allclose(np32(tstate["mu"][_paths(ttree).index("/fields/w")]),
                               np32(jstate[1][0].mu["fields"]["w"]), rtol=1e-6, atol=1e-9)
