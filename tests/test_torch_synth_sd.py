"""The port's ``runtime.synth_sd`` against the JAX package's, and its own
round trip, on the runway's tiny world (``tests/torch_parity.py``).

* ``synth_all`` of the port's trees equals the reference's ``synth_all`` of
  the same trees in the reference's layout, family by family: the same
  keys, shapes and float32 values.  The port keeps the Phi-3 matrices in
  bf16, as the HF asset stores them (the reference writes float32).
* ``convert(synth(p)) == p`` in the port for every route, bit for bit,
  except the HF tower's ``ln_post`` / ``proj``, which the converter fills
  with identity."""

import numpy as np
import pytest
import torch

from dynam3d_torch.runtime import synth_sd
from dynam3d_torch.tools import convert_reference_ckpt as ttool
from dynam3d_torch.tools.parity_run import with_identity_tail
from tests.torch_parity import assert_trees_identical, runway_world

FAMILIES = ("dynam3d", "clip", "llava", "vln_ckpt", "fastsam", "pretrain", "waypoint", "ddppo")


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg, trees, ref, sds = runway_world()
    port = synth_sd.synth_all(trees["params"], tcfg, render_params=trees["render"],
                              waypoint_params=trees["waypoint"], depth_params=trees["depth_enc"])
    return tcfg, trees, sds, port


def _phi3_matrix(key: str) -> bool:
    lm = "language_model." in key or key.endswith("lm_head.weight")
    return lm and not key.endswith("norm.weight")


@pytest.mark.parametrize("family", FAMILIES)
def test_synth_family_equals_the_reference(world, family):
    _, _, sds, port = world
    want, got = sds[family], port[family]
    assert sorted(got) == sorted(want)
    for k, ref in want.items():
        t = got[k]
        assert isinstance(t, torch.Tensor) and tuple(t.shape) == ref.shape, k
        assert t.dtype == (torch.bfloat16 if _phi3_matrix(k) else torch.float32), (k, t.dtype)
        np.testing.assert_array_equal(t.float().numpy(), ref, err_msg=k)


def test_trainer_checkpoint_shares_the_llava_tensors(world):
    """``synth_all`` writes the trainer checkpoint from the same tensors as
    the ``dynam3d`` and ``llava`` assets (no second copy of Phi-3)."""
    _, _, _, port = world
    for k, v in port["llava"].items():
        assert port["vln_ckpt"][f"net.llava.{k}"] is v
    for k, v in port["dynam3d"].items():
        assert port["vln_ckpt"][f"net.feature_fields.{k}"] is v


ROUND_TRIPS = {
    "dynam3d": ("dynam3d", ["fields"]),
    "pretrain": ("pretrain", ["fields", "render"]),
    "vln": ("vln_ckpt", ["fields", "llava", "patch_pos_emb", "inst_pos_emb", "zone_pos_emb",
                         "inst_proj", "zone_proj"]),
    "llava": ("llava", ["llava"]),
    "clip": ("clip", ["clip"]),
    "fastsam": ("fastsam", ["yolo"]),
    "waypoint": ("waypoint", ["waypoint"]),
    "ddppo": ("ddppo", ["depth_enc"]),
}


@pytest.mark.parametrize("route", sorted(ROUND_TRIPS))
def test_port_round_trip_is_exact(world, route):
    tcfg, trees, _, port = world
    family, parts = ROUND_TRIPS[route]
    params, extras, report = ttool.convert(tcfg, {route: port[family]}, device="cpu")
    assert sorted(report) == sorted(parts)
    truth = dict(trees["params"], render=trees["render"], waypoint=trees["waypoint"],
                 depth_enc=trees["depth_enc"])
    got = dict(params, **extras)
    for part in parts:
        want = truth[part]
        if part == "llava":
            want = with_identity_tail(want, got["llava"])
        assert_trees_identical(got[part], want, part)
