"""Port parity of the pretraining loop's data side: the procedural posed-
frames dataset and supervision tables (same numpy draws from the same
seed: exact), and ``PretrainRunner.build_batch`` with caller-given novel
views (mode ``explicit``) on the reference loop test's tiny config with a
float32 CLIP tower: ints exact, values 1e-5."""

import numpy as np
import pytest
import jax

from dynam3d_tpu.models.encoders.clip import init_clip_params
from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_torch.runtime import pretrain_loop as tloop
from tests.test_torch_pretrain_loop import CFG
from tests.torch_parity import np32, port_config, to_torch


@pytest.mark.parametrize("posed", [False, True])
def test_synthetic_frames_match_reference(posed):
    """The procedural dataset draws the same scenes from the same seed."""
    js = jloop.SyntheticFramesDataset(frames=3, seed=4, posed=posed).sample_scene()
    ts = tloop.SyntheticFramesDataset(frames=3, seed=4, posed=posed).sample_scene()
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(js[k]), err_msg=k)


def test_synthetic_supervision_matches_reference():
    js, ts = jloop.synthetic_supervision(3, 32), tloop.synthetic_supervision(3, 32)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_build_batch_with_explicit_novel_views():
    """``build_batch`` with caller-given novel views (mode ``explicit``):
    every batch field as the reference builds it (ints exact, values 1e-5)."""
    key = jax.random.PRNGKey(2)
    params = {"clip": init_clip_params(jax.random.fold_in(key, 2), CFG.clip)}
    scene = jloop.SyntheticFramesDataset(frames=3, seed=6).sample_scene()
    rng = np.random.default_rng(6)
    novel = {"rgb": rng.integers(0, 256, (2, 56, 56, 3)).astype(np.uint8),
             "position": rng.uniform(1, 7, (2, 3)).astype(np.float32),
             "heading": rng.uniform(0, 6, 2).astype(np.float32)}
    jb = jloop.PretrainRunner(dict(params), CFG).build_batch(scene, params["clip"], novel)
    trun = tloop.PretrainRunner(to_torch(params), port_config(CFG), device="cpu")
    tb = trun.build_batch(scene, trun.params["clip"], novel)
    for name in jb._fields:
        a, b = getattr(tb, name), np.asarray(getattr(jb, name))
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-5, atol=1e-5, err_msg=name)
