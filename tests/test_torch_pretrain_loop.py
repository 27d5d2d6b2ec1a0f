"""Port parity of the posed-frames pretraining loop (``PretrainRunner.run``
over ``SyntheticFramesDataset``): two iterations in three setups (unposed
frames, posed frames, two datasets drawn by the host-agreed draw) against
the JAX runner on the same parameters.  The reference loop test's tiny
config, with float32 CLIP and aggregation encoders.  Per-iteration metrics
within 1e-4 relative, the trained parameters after the run within 1e-5,
with two exceptions where Adam's normalized step turns float noise into a
move of up to the learning rate (1e-5 a step, so 4e-5 over two steps
either way): the key third of each attention ``qkv`` bias, whose gradient
is zero in exact arithmetic, and, in the ``render`` leaves (behind the
NeRF MLP's bf16 backward, see ``test_torch_render.py``), the few entries
whose gradient is within that noise of zero -- at most 0.5% of a leaf.
The posed setup is in ``test_torch_pretrain_loop_posed.py``."""


import numpy as np
import pytest
import jax

from dynam3d_tpu.config import CLIPConfig, Dynam3DConfig, FieldsConfig
from dynam3d_tpu.models.encoders.clip import init_clip_params
from dynam3d_tpu.models.memory3d import init_field_params
from dynam3d_tpu.models.render.nerf import init_render_params
from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_torch.runtime import pretrain_loop as tloop
from tests.torch_parity import assert_trained_close, port_config, to_torch

CFG = Dynam3DConfig(
    fields=FieldsConfig(
        input_height=4, input_width=4, fts_dim=32, patch_capacity=256, instance_capacity=64,
        zone_capacity=32, max_segments=8, max_members=32, max_zone_members=8, view_height=4,
        view_width=4, n_samples=17, n_importance=4, search_num=2, mlp_net_width=32,
        encoder_dtype="f32"),
    clip=CLIPConfig(
        image_size=56, patch_size=14, vision_width=32, vision_layers=1, vision_heads=2,
        embed_dim=32, text_context=8, text_width=16, text_layers=1, text_heads=2, vocab_size=32,
        compute_dtype="f32"),
)

SETUPS = {
    "unposed": lambda m: [m.SyntheticFramesDataset(frames=2, seed=0)],
    "posed": lambda m: [m.SyntheticFramesDataset(frames=2, seed=3, posed=True)],
    # the draw of seed 0 takes dataset 1, then dataset 0
    "two_datasets": lambda m: [m.SyntheticFramesDataset(frames=2, seed=0),
                               m.SyntheticFramesDataset(frames=2, seed=1, use_labels=False)],
}


def run_and_compare(setup: str) -> None:
    key = jax.random.PRNGKey(1)
    params = {
        "fields": init_field_params(key, CFG.fields),
        "render": init_render_params(jax.random.fold_in(key, 1), CFG.fields),
        "clip": init_clip_params(jax.random.fold_in(key, 2), CFG.clip),
    }
    jrun = jloop.PretrainRunner(dict(params), CFG)
    jhist = jrun.run(SETUPS[setup](jloop), iters=2)
    trun = tloop.PretrainRunner(to_torch(params), port_config(CFG), device="cpu")
    thist = trun.run(SETUPS[setup](tloop), iters=2)

    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j)
        assert not t["skipped"] and np.isfinite(t["loss"])
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert_trained_close(trun.params, jrun.params, CFG.fields.fts_dim, noise=4e-5)
    assert len(trun.timings) == 2


@pytest.mark.parametrize("setup", ["unposed", "two_datasets"])
def test_run_matches_reference(setup):
    run_and_compare(setup)

