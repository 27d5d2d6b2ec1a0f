"""Port parity of the pieces of the walk slice outside its main loop: the
CLIP text tower (``encode_text``, ``encode_all_text``) at float32 and bf16,
``hash_tokenize``, ``render_panorama`` and ``single_distance_ray_grid``.

Tolerances: the float32 text tower 1e-4 and the bf16 one 3e-2 (as the
vision tower in ``test_torch_clip.py``); tokens and the ray grid exactly;
the panorama's importance samples identical and its positions within 1e-5,
as ``test_torch_render.py`` holds one view; its features within 1e-4 plus
one bf16 step of their ray's largest feature (the MLP rounds to bf16 before
the ray is normalized, so a step lands on the ray's scale: one of 2048
features is 1% off its own value here), and 99% of them within one step of
their own value."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.config import CLIPConfig
from dynam3d_tpu.geom import projection as jproj
from dynam3d_tpu.models.encoders import clip as jclip
from dynam3d_tpu.models.encoders import clip_tokenizer as jtok
from dynam3d_tpu.models.render import nerf as jnerf
from dynam3d_torch.config import CLIPConfig as TCLIPConfig
from dynam3d_torch.convert import state_from_jax
from dynam3d_torch.geom import projection as tproj
from dynam3d_torch.models.encoders import clip as tclip
from dynam3d_torch.models.encoders import clip_tokenizer as ttok
from dynam3d_torch.models.render import nerf as tnerf
from tests.test_torch_render import CFG, _spy, _state_with_cloud, port_config_fields
from tests.torch_parity import np32, to_torch

TEXT_CFG = dict(image_size=56, patch_size=14, vision_width=32, vision_layers=1, vision_heads=2,
                embed_dim=32, text_context=16, text_width=32, text_layers=2, text_heads=4,
                vocab_size=64)
TEXTS = ["walk past the sofa", "stop at the kitchen table near the window",
         "turn left", " ".join(["go"] * 40)]


def _tokens(context):
    """Ids of ``hash_tokenize`` folded into the tiny vocabulary below its
    EOT (the argmax the towers read), EOT kept at the top."""
    ids = jtok.hash_tokenize(TEXTS, context)
    small = np.where(ids == jtok.EOT, 63, ids % 62 + (ids > 0))
    return small.astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_text_tower_matches(dtype):
    jcfg = CLIPConfig(**TEXT_CFG)
    tcfg = TCLIPConfig(**TEXT_CFG)
    jp = jclip.init_clip_params(jax.random.PRNGKey(3), jcfg)
    tol = 1e-4
    if dtype == "bf16":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        tol = 3e-2
    tp = to_torch(jp)
    tokens = _tokens(jcfg.text_context)
    assert (tokens.argmax(-1) == (tokens == 63).argmax(-1)).all()
    want = jclip.encode_text(jp, jcfg, jnp.asarray(tokens))
    got = tclip.encode_text(tp, tcfg, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 32)
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)
    jall, jsep = jclip.encode_all_text(jp, jcfg, jnp.asarray(tokens))
    tall, tsep = tclip.encode_all_text(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(np32(tall), np32(jall), rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(tsep), np32(jsep), rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(tsep), np32(got), rtol=1e-6, atol=1e-6)
    eot = tokens.argmax(-1)
    assert (np32(tall)[np.arange(16)[None, :] > eot[:, None]] == 0).all()


def test_init_clip_params_text_tower_shapes_and_vision_draws():
    """The text subtree has the reference's shapes; the vision tower draws
    the same values with it as the generator gave before it existed."""
    jcfg = CLIPConfig(**TEXT_CFG)
    tcfg = TCLIPConfig(**TEXT_CFG)
    jp = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    tp = tclip.init_clip_params(torch.Generator().manual_seed(5), tcfg, "cpu")
    shapes = lambda t: [tuple(x.shape) for x in jax.tree_util.tree_leaves(t)]  # noqa: E731
    assert shapes(tp["text"]) == shapes(jp["text"])
    assert shapes(tp["visual"]) == shapes(jp["visual"])
    g = torch.Generator().manual_seed(5)
    assert torch.equal(tp["visual"]["conv1_w"],
                       torch.randn(14 * 14 * 3, 32, generator=g) * 32 ** -0.5)


def test_hash_tokenize_matches():
    texts = TEXTS + ["", "The  Kitchen\tTable", "x " * 100]
    for context in (77, 8):
        got = ttok.hash_tokenize(texts, context)
        np.testing.assert_array_equal(got, jtok.hash_tokenize(texts, context))
        assert got.dtype == np.int32 and (got.argmax(-1) == (got == ttok.EOT).argmax(-1)).all()
    assert (ttok.BOS, ttok.EOT, ttok.CONTEXT) == (jtok.BOS, jtok.EOT, jtok.CONTEXT)


def test_render_panorama_matches(monkeypatch):
    jp = jnerf.init_render_params(jax.random.PRNGKey(3), CFG)
    js = _state_with_cloud()
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    jseen, tseen = [], []
    _spy(monkeypatch, jnerf, jseen)
    _spy(monkeypatch, tnerf, tseen)
    pos, hd = np.float32([0.2, -0.5, 0.3]), np.float32(2.9)
    jf, jpos = jnerf.render_panorama(jp, CFG, js, jnp.asarray(pos), jnp.asarray(hd))
    tf, tpos = tnerf.render_panorama(to_torch(jp), port_config_fields(), ts,
                                     torch.from_numpy(pos), torch.tensor(hd))
    assert tuple(tf.shape) == (4, 16, 32) and tuple(tpos.shape) == (4, 16, 3)
    assert len(tseen) == len(jseen) == 4
    for a, b in zip(tseen, jseen):
        np.testing.assert_array_equal(a, b)
    got, ref = np32(tf), np32(jf)
    ray_scale = np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(got - ref) <= 1e-4 + 2.0 ** -8 * ray_scale).all()
    assert np.mean(np.abs(got - ref) <= 1e-4 + 2.0 ** -8 * np.abs(ref)) >= 0.99
    np.testing.assert_allclose(np32(tpos), np32(jpos), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (6, 8)])
def test_single_distance_ray_grid_matches(hw):
    kw = dict(height=hw[0], width=hw[1], hfov_deg=79.0, distance=2.5)
    for a, b in zip(tproj.single_distance_ray_grid(**kw), jproj.single_distance_ray_grid(**kw)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
