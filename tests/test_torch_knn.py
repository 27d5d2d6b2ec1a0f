"""Port parity of the k-NN family (``ops/knn.py``, ``ops/pallas_knn.py``):
``knn_tiled``, ``knn_banded`` in both modes, the Morton order, and kernel
D's plain version against the TPU kernel run in interpret mode.  Ids must
be equal where distances are separated; distances within 1e-5 (float32
expansion, sums in another order)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dynam3d_tpu.ops import knn as jknn
from dynam3d_tpu.ops.pallas_knn import pallas_knn
from dynam3d_torch.ops import knn as tknn


def _table(seed, P, dead_frac=0.2, dead_range=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    valid = rng.uniform(size=P) > dead_frac
    if dead_range is not None:
        valid[dead_range[0]:dead_range[1]] = False
    return pts, valid


def _queries(seed, Q):
    return np.random.default_rng(seed + 100).uniform(-3, 3, (Q, 3)).astype(np.float32)


def test_knn_tiled_matches_reference():
    pts, valid = _table(0, 3000)
    q = _queries(0, 700)
    jd, ji = jknn.knn_tiled(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(valid), 4,
                            tile=1024, q_chunk=256)
    td, ti = tknn.knn_tiled(torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(valid), 4,
                            q_chunk=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_indices", [True, False])
def test_knn_banded_is_radius_exact(with_indices):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 8, (2500, 3)).astype(np.float32)
    valid = rng.uniform(size=2500) > 0.1
    rays = np.cumsum(rng.uniform(0, 0.05, (12, 40, 3)), axis=1).astype(np.float32) + 2.0
    radius = 0.6
    args = (4, radius)
    jd, ji = jknn.knn_banded(jnp.asarray(rays), jnp.asarray(pts), jnp.asarray(valid), *args,
                             tile=512, band=8, with_indices=with_indices)
    td, ti = tknn.knn_banded(torch.from_numpy(rays), torch.from_numpy(pts),
                             torch.from_numpy(valid), *args, tile=512, band=8,
                             with_indices=with_indices)
    jd, td = np.asarray(jd), td.numpy()
    inside = jd < radius * radius
    assert inside.any() and (~inside).any()
    # radius-exact: the same distances wherever the reference found them in range
    np.testing.assert_allclose(td[inside], jd[inside], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(td >= radius * radius, ~inside)
    if with_indices:
        np.testing.assert_array_equal(ti.numpy()[inside], np.asarray(ji)[inside])
    else:
        assert (ti.numpy() == -1).all()
    # and the same as an exact scan inside the radius
    ed, _ = tknn.knn_tiled(torch.from_numpy(rays.reshape(-1, 3)), torch.from_numpy(pts),
                           torch.from_numpy(valid), 4)
    np.testing.assert_allclose(td[inside], ed.numpy()[inside], rtol=1e-6, atol=1e-6)


def test_morton_perm_matches_reference():
    pts, valid = _table(5, 1500, dead_frac=0.3)
    pts[~valid] = -10000.0                         # tombstones
    jc = np.asarray(jknn.morton_codes(jnp.asarray(pts), jnp.asarray(valid)))
    tc = tknn.morton_codes(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(tc, jc)
    jp = np.asarray(jknn.morton_perm(jnp.asarray(pts), jnp.asarray(valid)))
    tp = tknn.morton_perm(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("case", ["dead_chunk", "few_live"])
def test_kernel_d_plain_matches_pallas_knn(case):
    """``knn_topk_plain`` is kernel D's contract: the TPU kernel in
    interpret mode at Q=300, P=1100.  ``dead_chunk``: dead slots and a
    fully dead 256-point chunk, chunked scan; ``few_live``: three live
    points, one chunk, so the (1e10, -1) tail shows."""
    P = 1100
    if case == "dead_chunk":
        pts, valid = _table(7, P, dead_range=(256, 512))
        chunk = 256
    else:
        pts, valid = _table(8, P)
        valid[:] = False
        valid[[5, 600, 1099]] = True
        chunk = 2048
    q = _queries(7, 300)
    jd, ji = pallas_knn(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(valid), 4,
                        tile_q=128, chunk=chunk, interpret=True)
    td, ti = tknn.knn_topk(torch.from_numpy(q), torch.from_numpy(pts),
                           torch.from_numpy(valid), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    if case == "few_live":
        assert (ti.numpy()[:, 3] == -1).all() and (td.numpy()[:, 3] == 1e10).all()


def test_knn_auto_takes_the_tiled_scan_on_the_cpu(monkeypatch):
    monkeypatch.setenv("DYNAM3D_ENABLE_PALLAS_KNN", "1")
    pts, valid = _table(9, 1500)
    q = torch.from_numpy(_queries(9, 50))
    d, i = tknn.knn_auto(q, torch.from_numpy(pts), torch.from_numpy(valid), 3)
    ed, ei = tknn.knn_tiled(q, torch.from_numpy(pts), torch.from_numpy(valid), 3)
    assert torch.equal(i, ei) and torch.equal(d, ed)

