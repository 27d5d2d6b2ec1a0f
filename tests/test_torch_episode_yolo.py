"""The main path at its default segmenter: ``perceive`` and a 3-step
``EpisodeRunner`` episode on the tiny slice config with its own YOLOv8-seg
provider (imgsz 32, width 0.125), through the port and through the JAX
package with the same converted weights.

Multimodal tokens within 1e-3 (two float32 towers, the aggregation encoders
and the projectors summed in another order); token validity, memory slots,
generated ids and action text exactly.  ``conf`` is set so that at least two
masks survive NMS in every view the episode segments (asserted), so the
learned segmenter, not an empty id map, shapes the memory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.runtime.episode import EpisodeRunner as JRunner
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.models.encoders import yolov8_seg
from dynam3d_torch.runtime.episode import EpisodeRunner as TRunner
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed
from tests.torch_parity import np32, port_config, slice_config, to_torch

CONF = 0.5


@pytest.fixture(scope="module")
def yolo_slice():
    cfg = slice_config(provider="yolov8")
    cfg = dataclasses.replace(cfg, segmenter=dataclasses.replace(cfg.segmenter, conf=CONF))
    assert cfg.segmenter.provider == "yolov8"
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), cfg, llm_dtype=jnp.float32)
    assert "yolo" in jp
    return cfg, port_config(cfg), jp


@pytest.fixture
def masks_kept(monkeypatch):
    """The number of masks NMS keeps in each view the port segments."""
    kept = []
    real = yolov8_seg.nms_select

    def recording(*a, **k):
        idx, valid = real(*a, **k)
        kept.extend(valid.sum(-1).tolist())
        return idx, valid

    monkeypatch.setattr(yolov8_seg, "nms_select", recording)
    return kept


def test_init_builds_the_yolo_tree(yolo_slice):
    jcfg, tcfg, jp = yolo_slice
    tp = tpolicy.init_policy_params(0, tcfg, llm_dtype=torch.float32, device="cpu")
    shapes = [tuple(np.shape(a)) for a in jax.tree_util.tree_leaves(jp["yolo"])]
    ours = [t.shape for t in jax.tree_util.tree_leaves(tp["yolo"])]
    # the port keeps OIHW where the reference keeps HWIO
    assert [(s[3], s[2], s[0], s[1]) if len(s) == 4 else s for s in shapes] == \
        [tuple(s) for s in ours]


def test_perceive_matches(yolo_slice, masks_kept):
    jcfg, tcfg, jp = yolo_slice
    tp = to_torch(jp)
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 255, (1, 1, 56, 56, 3), dtype=np.uint8)
    depth = TRunner.pack_depth(rng.uniform(0.05, 0.9, (1, 1, 32, 32)))   # uint16 wire
    pos = np.float32([[1.0, 1.25, 2.0]])
    hd = np.float32([0.3])
    jperceive = jax.jit(jpolicy.perceive, static_argnums=1)   # eager dispatch is slow here
    jout = jperceive(jp, jcfg, jpolicy.batched_init_state(jcfg, 1), jnp.asarray(rgb),
                     jnp.asarray(depth), jnp.asarray(pos), jnp.asarray(hd))
    tout = tpolicy.perceive(tp, tcfg, tpolicy.batched_init_state(tcfg, 1, "cpu"),
                            torch.from_numpy(rgb), torch.from_numpy(depth),
                            torch.from_numpy(pos), torch.from_numpy(hd))
    assert masks_kept and min(masks_kept) >= 2, masks_kept
    np.testing.assert_array_equal(tout.mm_valid.numpy(), np.asarray(jout.mm_valid))
    np.testing.assert_allclose(np32(tout.mm_tokens), np32(jout.mm_tokens), rtol=1e-3, atol=1e-3)
    for name in ("patch_valid", "patch_owner", "inst_valid", "zone_valid"):
        np.testing.assert_array_equal(np32(getattr(tout.state, name)),
                                      np32(getattr(jout.state, name)), err_msg=name)
    assert int(tout.n_inst[0]) == int(jout.n_inst[0]) >= 1


def test_episode_ids_and_text_identical(yolo_slice, masks_kept):
    jcfg, tcfg, jp = yolo_slice
    tp = to_torch(jp)
    jr = JRunner(jp, jcfg)
    jgens = []
    step = jr._full_step

    def capture(*a, **k):
        st, g = step(*a, **k)
        jgens.append(np.asarray(g)[0].tolist())
        return st, g

    jr._full_step = capture
    jres = jr.run([JFeed(rgb_size=56, depth_size=32, views=1, seed=0)], max_steps=3,
                  ignore_stop=True)
    tr = TRunner(tp, tcfg, device="cpu")
    tres = tr.run([TFeed(rgb_size=56, depth_size=32, views=1, seed=0)], max_steps=3,
                  ignore_stop=True)

    assert len(masks_kept) == 3 and min(masks_kept) >= 2, masks_kept
    assert len(jgens) == len(tr.step_log) == 3
    for s, jg in zip(tr.step_log, jgens):
        assert s["gen"] == jg, (s["step"], s["gen"], jg)
        text = jr.tok.decode(jg)
        text = text[: text.find("<|end|>")] if "<|end|>" in text else text
        assert s["text"] == text
    assert tres[0]["steps"] == jres[0]["steps"] == 3
    np.testing.assert_allclose(tres[0]["distance_to_goal"], jres[0]["distance_to_goal"],
                               rtol=1e-6)
