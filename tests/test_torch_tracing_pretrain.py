"""The 3DFF frames iteration's spans and counters
(``runtime/profiling.py``) on the CPU, at the benchmark's small test
configuration (``perfbench/tests/tiny-fields.json``).

With recording on, each iteration records each ``pretrain.*`` span once
(``pretrain.render`` once a novel view), all carrying
the iteration as their step, and the counters ``pretrain.iters``, ``sync``
and ``render.near_tiles``; the backward's recompute of the views records
no second ``pretrain.fold``.  Off, it records nothing, and the iteration's
metrics are the same either way.
"""

import json
import os
from collections import Counter

import pytest
import torch

from dynam3d_torch.config import from_dict
from dynam3d_torch.runtime import pretrain_loop as tloop
from dynam3d_torch.runtime import profiling
from perfbench import weights_fields
from perfbench.reference import fields_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONCE = ("pretrain.iter", "pretrain.load", "pretrain.build", "pretrain.build.clip",
        "pretrain.build.geometry", "pretrain.fold", "pretrain.losses", "pretrain.backward",
        "pretrain.update")
PER_VIEW = ("pretrain.render",)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.disable()
    profiling.reset()
    profiling.set_step(None)
    yield
    profiling.disable()
    profiling.reset()
    profiling.set_step(None)


def _run(iters: int, record: bool):
    conf = json.load(open(os.path.join(ROOT, "perfbench", "tests", "tiny-fields.json")))
    cfg = from_dict(conf["model"])
    params = weights_fields.fields_params(3, fields_ref.config(conf["model"]), torch.device("cpu"))
    runner = tloop.PretrainRunner(params, cfg, seed=3, device="cpu")
    ds = tloop.SyntheticFramesDataset(rgb_size=cfg.clip.image_size, depth_size=32, frames=3,
                                      seed=3)
    if record:
        profiling.enable()
    try:
        return runner.run([ds], iters)
    finally:
        profiling.disable()


def test_each_span_once_an_iteration_and_the_counters():
    hist = _run(2, record=True)
    spans = profiling.spans()
    for it in (0, 1):
        names = Counter(s.name for s in spans if s.step == it)
        for n in ONCE:
            assert names[n] == 1, (it, n, names)
        for n in PER_VIEW:
            assert names[n] == 2, (it, n, names)    # the two novel views
    assert {s.step for s in spans} == {0, 1}
    by = {(s.name, s.step): s for s in spans}
    for it in (0, 1):
        outer = by["pretrain.iter", it]
        for n in ONCE[1:]:
            s = by[n, it]
            assert outer.start <= s.start <= s.end <= outer.end, n
        assert by["pretrain.build.clip", it].parent == "pretrain.build"
        assert by["pretrain.fold", it].end <= by["pretrain.losses", it].start
        assert by["pretrain.losses", it].end <= by["pretrain.backward", it].start
        assert by["pretrain.backward", it].end <= by["pretrain.update", it].start
    c = profiling.counts()
    assert c["pretrain.iters"] == 2
    assert c["render.near_tiles"] > 0
    # per iteration at least: each view's fold reads and the backward's
    # recompute of them, the near-mask reads, the skip read, six metrics
    assert c["sync"] >= 2 * (2 * 3 * 2 + 2 + 1 + 6)
    assert len(hist) == 2


def test_the_recompute_records_no_second_fold():
    _run(1, record=True)
    folds = [s for s in profiling.spans() if s.name == "pretrain.fold"]
    back = next(s for s in profiling.spans() if s.name == "pretrain.backward")
    assert len(folds) == 1 and folds[0].end <= back.start


def test_off_records_nothing_and_changes_nothing():
    off = _run(1, record=False)
    assert profiling.spans() == [] and profiling.counts() == {}
    on = _run(1, record=True)
    assert on == off
