"""Port parity of the perception encoders: CLIP ``preprocess_rgb`` (with
and without the cubic resize), ``encode_image`` (projected CLS + patch grid,
and ``hidden_layer=-2``), the LLaVA tower + projector, and
``preprocess_depth``, against the JAX package on the same weights.

Tolerances: float32 tower 1e-4 (two layers of matmul chains summed in
another order); resize 1e-5; bf16 tower 3e-2 (bf16 rounds at slightly
different places in the two frameworks)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models.encoders import clip as jclip
from dynam3d_tpu.models.encoders.depth_resnet import preprocess_depth as j_pre_depth
from dynam3d_tpu.models.vlm import llava as jllava
from dynam3d_torch.models.encoders import clip as tclip
from dynam3d_torch.models.encoders.depth_resnet import preprocess_depth as t_pre_depth
from dynam3d_torch.models.vlm import llava as tllava
from tests.torch_parity import np32, port_config, slice_config, to_torch


@pytest.fixture(scope="module")
def towers():
    jcfg = slice_config()
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg.clip)
    return jcfg, port_config(jcfg), jp, to_torch(jp)


@pytest.mark.parametrize("size", [56, 40, 70])
def test_preprocess_rgb(size):
    rgb = np.random.default_rng(size).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    j = jclip.preprocess_rgb(jnp.asarray(rgb), 56)
    t = tclip.preprocess_rgb(torch.from_numpy(rgb), 56)
    np.testing.assert_allclose(np32(t), np32(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_image_and_hidden_layer(towers, dtype):
    jcfg, tcfg, jp, tp = towers
    rgb = np.random.default_rng(1).integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    jpx = jclip.preprocess_rgb(jnp.asarray(rgb), 56)
    tpx = tclip.preprocess_rgb(torch.from_numpy(rgb), 56)
    tol = 1e-4
    if dtype == "bf16":
        jpx, tpx, tol = jpx.astype(jnp.bfloat16), tpx.to(torch.bfloat16), 3e-2
    jc, jg = jclip.encode_image(jp, jcfg.clip, jpx)
    tc, tg = tclip.encode_image(tp, tcfg.clip, tpx)
    np.testing.assert_allclose(np32(tc), np32(jc), rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(tg), np32(jg), rtol=tol, atol=tol)
    jh = jclip.encode_image(jp, jcfg.clip, jpx, hidden_layer=-2)
    th = tclip.encode_image(tp, tcfg.clip, tpx, hidden_layer=-2)
    assert th.shape == jh.shape == (2, 17, 64)
    np.testing.assert_allclose(np32(th), np32(jh), rtol=tol, atol=tol)


def test_llava_image_features():
    jcfg = slice_config()
    tcfg = port_config(jcfg)
    jp = jllava.init_llava_params(jax.random.PRNGKey(2), jcfg.llava, jcfg.clip,
                                  dtype=jnp.float32)
    jp.pop("phi3")
    tp = to_torch(jp)
    rgb = np.random.default_rng(3).integers(0, 256, (1, 56, 56, 3), dtype=np.uint8)
    j = jllava.image_features(jp, jcfg.llava, jcfg.clip,
                              jclip.preprocess_rgb(jnp.asarray(rgb), 56))
    t = tllava.image_features(tp, tcfg.llava, tcfg.clip,
                              tclip.preprocess_rgb(torch.from_numpy(rgb), 56))
    np.testing.assert_allclose(np32(t), np32(j), rtol=1e-4, atol=1e-4)


def test_preprocess_depth():
    d = np.random.default_rng(4).uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    d[d < 0.2] = 0.0                              # invalid pixels take the column max
    np.testing.assert_allclose(np32(t_pre_depth(torch.from_numpy(d))),
                               np32(j_pre_depth(jnp.asarray(d))), rtol=1e-6)
