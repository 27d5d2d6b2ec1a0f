"""``policy.perceive`` at the default bf16 precision: the aggregation
encoders, their GELU, the projectors and the CLIP tower in bf16
(``slice_config(f32=False)``), through the port and the JAX package with
the same converted weights on the uint16 depth wire format.

Token validity and memory slots exactly.  Multimodal tokens within 2**-6
of their scale at most (four bf16 steps; measured 0.0303 on a scale of
3.05) and 2**-8 of it on average (measured 0.0036): every bf16 rounding of
a matmul, norm or activation may land a step apart between the
frameworks, and the steps add up through the encoder layers.  The GELU is
one such place: ``jax.nn.gelu`` on bf16 rounds ``erfc`` (and, eager, its
argument and its product) to bf16 with a bf16 ``sqrt(0.5)``, the port
rounds an f32 GELU once; doing it the reference's jitted way moved the
largest token error only from 0.0303 to 0.0290."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from tests.torch_parity import np32, port_config, slice_config, to_torch


def test_perceive_matches_at_bf16():
    jcfg = slice_config(f32=False)
    assert (jcfg.fields.encoder_dtype, jcfg.clip.compute_dtype) == ("bf16", "bf16")
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    tcfg = port_config(jcfg)
    tp = to_torch(jp)
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 255, (1, 1, 56, 56, 3), dtype=np.uint8)
    depth = TRunner.pack_depth(rng.uniform(0.05, 0.9, (1, 1, 32, 32)))
    pos = np.float32([[1.0, 1.25, 2.0]])
    hd = np.float32([0.3])
    jout = jpolicy.perceive(jp, jcfg, jpolicy.batched_init_state(jcfg, 1), jnp.asarray(rgb),
                            jnp.asarray(depth), jnp.asarray(pos), jnp.asarray(hd))
    tout = tpolicy.perceive(tp, tcfg, tpolicy.batched_init_state(tcfg, 1, "cpu"),
                            torch.from_numpy(rgb), torch.from_numpy(depth),
                            torch.from_numpy(pos), torch.from_numpy(hd))
    valid = np.asarray(jout.mm_valid)
    np.testing.assert_array_equal(tout.mm_valid.numpy(), valid)
    for name in ("patch_valid", "patch_owner", "inst_valid", "zone_valid"):
        np.testing.assert_array_equal(np32(getattr(tout.state, name)),
                                      np32(getattr(jout.state, name)), err_msg=name)
    assert int(tout.n_inst[0]) == int(jout.n_inst[0]) >= 1
    got, ref = np32(tout.mm_tokens)[valid], np32(jout.mm_tokens)[valid]
    scale = np.abs(ref).max()
    err = np.abs(got - ref)
    assert err.max() <= 2.0 ** -6 * scale, (err.max(), scale)
    assert err.mean() <= 2.0 ** -8 * scale, (err.mean(), scale)
