"""Port parity of the 3D memory (``models/memory3d``): the tables after 1
and 3 views (frustum forgetting before each later view), with eviction
forced in one case, against the JAX package on the same parameters and
inputs.  Encoders run float32 (``fields.encoder_dtype="f32"``).

Validity masks, owners, write stamps and slot choices must match exactly;
float values within 1e-4 (aggregation-encoder matmul chains summed in
another order)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import Dynam3DConfig, FieldsConfig
from dynam3d_tpu.models import memory3d as jm
from dynam3d_tpu.models.segmenter import depth_plane_segments
from dynam3d_torch.models import memory3d as tm
from dynam3d_torch.models.memory3d.update import scatter_drop
from tests.torch_parity import np32, port_config, to_torch

EXACT = ("patch_owner", "patch_valid", "patch_step", "inst_valid", "inst_gt_id", "zone_valid")


def _fields(patch_capacity=256):
    return FieldsConfig(input_height=4, input_width=4, fts_dim=64,
                        patch_capacity=patch_capacity, instance_capacity=64,
                        zone_capacity=32, max_segments=8, max_members=32,
                        max_zone_members=16, encoder_dtype="f32")


def _views(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for v in range(n):
        d = np.repeat(rng.uniform(1.0, 4.0, (2, 1)), 8, axis=1).reshape(-1)   # two planes
        d = (d + rng.normal(scale=0.02, size=16)).astype(np.float32)
        grid = rng.normal(size=(16, 64)).astype(np.float32)
        pos = np.float32([0.3 * v, -0.2 * v, 1.25])
        heading = np.float32(0.4 * v)
        dmap = rng.uniform(0.05, 0.6, (16, 16)).astype(np.float32) * 10
        out.append((d, grid, pos, heading, dmap))
    return out


def _compare(ts, js):
    for name in js._fields:
        a, b = np32(getattr(ts, name)), np32(getattr(js, name))
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("patch_capacity", [256, 32])     # 32: oldest-first eviction
def test_tables_after_one_and_three_views(patch_capacity):
    jcfg = _fields(patch_capacity)
    tcfg = port_config(Dynam3DConfig(fields=jcfg)).fields
    jp = jm.init_field_params(jax.random.PRNGKey(4), jcfg)   # a key that merges
    tp = to_torch(jp)
    js = jm.init_state(jcfg, fts_dtype=jnp.float32)
    ts = tm.init_state(tcfg, "cpu", fts_dtype=torch.float32)
    upd = jax.jit(lambda p, s, d, g, sg, pos, h: jm.update_view(p, s, jcfg, d, g, sg, pos, h)[0])
    dele = jax.jit(lambda s, dm, pos, h: jm.delete_from_frustum(s, jcfg, dm, pos, h))
    merges = 0
    for v, (d, grid, pos, heading, dmap) in enumerate(_views(3, patch_capacity)):
        segm = np.array(depth_plane_segments(jnp.asarray(d), 4, 4, 8))
        if v:
            js = dele(js, jnp.asarray(dmap), jnp.asarray(pos), jnp.float32(heading))
            ts = tm.delete_from_frustum(ts, tcfg, torch.from_numpy(dmap), torch.from_numpy(pos),
                                        torch.tensor(heading))
            _compare(ts, js)
        js = upd(jp, js, jnp.asarray(d), jnp.asarray(grid), jnp.asarray(segm),
                 jnp.asarray(pos), jnp.float32(heading))
        ts, aux = tm.update_view(tp, ts, tcfg, torch.from_numpy(d), torch.from_numpy(grid),
                               torch.from_numpy(segm), torch.from_numpy(pos),
                               torch.tensor(heading))
        merges += int(aux.is_merge.sum())
        if v in (0, 2):
            _compare(ts, js)
    assert int(ts.inst_valid.sum()) >= 2
    assert merges >= 1                          # the re-aggregation path ran
    if patch_capacity == 32:
        assert bool(ts.patch_valid.all())       # the table filled and evicted


def test_environment_features():
    jcfg = _fields()
    js = jm.init_state(jcfg)
    rng = np.random.default_rng(9)
    ipos = rng.uniform(-8, 8, (64, 3)).astype(np.float32)
    ival = rng.uniform(size=64) < 0.6
    js = js._replace(inst_pos=jnp.asarray(ipos), inst_valid=jnp.asarray(ival),
                     zone_pos=jnp.asarray(ipos[:32]), zone_valid=jnp.asarray(ival[:32]))
    cam, hd = np.float32([1.0, -2.0, 1.25]), np.float32(0.7)
    je = jm.environment_features(js, jnp.asarray(cam), jnp.float32(hd))
    ts = tm.FieldState(*(torch.from_numpy(np.array(np32(t) if t.dtype != bool else t))
                         for t in js))
    te = tm.environment_features(ts, torch.from_numpy(cam), torch.tensor(hd))
    for a, b in zip(te, je):
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-5)


def test_scatter_drop_skips_the_sentinel_row():
    t = torch.zeros(4, 2)
    out = scatter_drop(t, torch.tensor([1, 4, 3]), torch.tensor([[1.0, 1], [9, 9], [3, 3]]))
    np.testing.assert_array_equal(out.numpy(), [[0, 0], [1, 1], [0, 0], [3, 3]])
    assert t.abs().sum() == 0                    # the input is left as it was
