"""Port parity of ``PretrainRunner.run`` over the posed-frame scene
datasets written by ``chip_smoke``'s corpus writers (the fixtures of
``test_torch_scene_datasets.py``), against the JAX runner on the reference
loop test's tiny config with the tolerances of
``test_torch_pretrain_loop.py``: per-iteration metrics within 1e-4
relative, the trained ``fields`` / ``render`` within 1e-5 save Adam's
noise entries."""

import numpy as np
import pytest

from dynam3d_tpu.runtime import pretrain_loop as jloop
from dynam3d_tpu.runtime import scene_datasets as jsd
from dynam3d_torch.runtime import pretrain_loop as tloop
from dynam3d_torch.runtime import scene_datasets as tsd
from tests.test_torch_pretrain_loop import CFG
from tests.test_torch_scene_datasets import _datasets, corpora, params  # noqa: F401
from tests.torch_parity import assert_trained_close, port_config, to_torch


def test_run_matches_reference(corpora, params):
    """``PretrainRunner.run`` over ``[ScanNetScenes, ARKitScenes]`` for two
    iterations (the draw of seed 0 takes ARKit, then ScanNet): per-iteration
    metrics within 1e-4 relative and the trained ``fields`` / ``render`` as
    ``test_torch_pretrain_loop.py`` holds them."""
    jrun = jloop.PretrainRunner(dict(params), CFG)
    jhist = jrun.run([_datasets(jsd, corpora, n, 2, seed=6) for n in ("scannet", "arkit")], 2)
    trun = tloop.PretrainRunner(to_torch(params), port_config(CFG), device="cpu")
    thist = trun.run([_datasets(tsd, corpora, n, 2, seed=6) for n in ("scannet", "arkit")], 2)
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j) and not t["skipped"]
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert_trained_close(trun.params, jrun.params, CFG.fields.fts_dim, noise=4e-5)
    assert [sorted(t) for t in trun.timings] == [["build_s", "load_s", "step_s"]] * 2


def test_structured3d_step_without_a_cloud(corpora, params):
    """A Structured3D sample has no gt cloud: the reference's step raises
    (``top_k`` of k=1 over zero points); the port's batch carries one dead
    point and its step equals the reference's on the same scene with one
    far point of label 0 (no ray and no segment finds an instance)."""
    ds = _datasets(jsd, corpora, "structured3d", 2, seed=8)
    scene = ds.sample_scene()
    with pytest.raises(ValueError, match="top_k"):
        jloop.PretrainRunner(dict(params), CFG).run([_Fixed(scene)], 1)
    far = dict(scene, gt_xyz=np.full((1, 3), 1e4, np.float32), gt_label=np.zeros(1, np.int32))
    jhist = jloop.PretrainRunner(dict(params), CFG).run([_Fixed(far)], 1)
    trun = tloop.PretrainRunner(to_torch(params), port_config(CFG), device="cpu")
    thist = trun.run([_Fixed(scene)], 1)
    for k in jhist[0]:
        np.testing.assert_allclose(thist[0][k], jhist[0][k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert thist[0]["lang_loss"] == 0.0


class _Fixed:
    def __init__(self, scene):
        self.scene = scene

    def sample_scene(self):
        return dict(self.scene)
