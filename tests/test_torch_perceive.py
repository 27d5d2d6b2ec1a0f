"""The perception half of the slice: ``policy.perceive`` on the uint16
depth wire format through the port and the JAX package with the same
converted weights (tiny slice config, depth_plane segmenter, float32
encoders).

Multimodal tokens within 1e-3 (two float32 towers, the aggregation
encoders and the projectors summed in another order); token validity and
memory slots exactly."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from tests.torch_parity import np32, port_config, slice_config, to_torch


@pytest.fixture(scope="module")
def slice_params():
    cfg = slice_config()
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), cfg, llm_dtype=jnp.float32)
    return cfg, port_config(cfg), jp


def test_perceive_matches(slice_params):
    jcfg, tcfg, jp = slice_params
    tp = to_torch(jp)
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 255, (1, 1, 56, 56, 3), dtype=np.uint8)
    depth = TRunner.pack_depth(rng.uniform(0.05, 0.9, (1, 1, 32, 32)))   # uint16 wire
    pos = np.float32([[1.0, 1.25, 2.0]])
    hd = np.float32([0.3])
    jout = jpolicy.perceive(jp, jcfg, jpolicy.batched_init_state(jcfg, 1), jnp.asarray(rgb),
                            jnp.asarray(depth), jnp.asarray(pos), jnp.asarray(hd))
    tout = tpolicy.perceive(tp, tcfg, tpolicy.batched_init_state(tcfg, 1, "cpu"),
                            torch.from_numpy(rgb), torch.from_numpy(depth),
                            torch.from_numpy(pos), torch.from_numpy(hd))
    np.testing.assert_array_equal(tout.mm_valid.numpy(), np.asarray(jout.mm_valid))
    np.testing.assert_allclose(np32(tout.mm_tokens), np32(jout.mm_tokens), rtol=1e-3, atol=1e-3)
    for name in ("patch_valid", "patch_owner", "inst_valid", "zone_valid"):
        np.testing.assert_array_equal(np32(getattr(tout.state, name)),
                                      np32(getattr(jout.state, name)), err_msg=name)
    assert int(tout.n_inst[0]) == int(jout.n_inst[0]) >= 1
