"""Eval and inference on two gloo ranks (the CPU) against one process.

``run.main`` at ``WORLD_SIZE = 2`` shards the episodes by rank and merges
them (``tests/torch_dist.py::run_cli``, one spawn for the file): rank 0
writes ``stats_ckpt.json`` over all 8 episodes and one ``_preds.json`` of
all 4 paths, and each must equal, as JSON text, the file of one process
over the same feeds (``run.main`` at ``WORLD_SIZE = 1``, run here with one
intra-op thread, as the ranks are, so both compute the same bits).  Each
rank keeps its own ``stats_ep_ckpt_r{rank}_w2.json``; an rxr inference
file merged over the ranks equals one process's, line for line, in
episode order.  Tolerance: none, the files are compared exactly.
"""

import json
import os

import pytest
import torch

from dynam3d_torch import run as trun
from dynam3d_torch.parallel.spawn import run_ranks
from tests import torch_dist
from tests.test_torch_run_cli import OPTS, _write_config
from tests.torch_parity import slice_config


def _argvs(cfg_path):
    base = ["--exp-config", cfg_path, "--exp_name", "m"] + OPTS + ["train.max_traj_len=1"]
    return [base[:2] + ["--run-type", "eval"] + base[2:],
            base[:2] + ["--run-type", "inference"] + base[2:]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg_path = _write_config(tmp_path_factory.mktemp("cfg") / "cfg.json", slice_config())
    two, one = tmp_path_factory.mktemp("two"), tmp_path_factory.mktemp("one")
    ranks = run_ranks(torch_dist.run_cli, 2, args=(str(two), _argvs(cfg_path)), timeout=300)
    threads = torch.get_num_threads()
    cwd = os.getcwd()
    torch.set_num_threads(1)
    os.chdir(one)
    try:
        for argv in _argvs(cfg_path):
            trun.main(argv, device="cpu")
        single = torch_dist.rxr_inference(0, 1, str(one), _argvs(cfg_path)[0])
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    return dict(two=two, one=one, ranks=ranks, single=single)


def test_merged_stats_equal_one_process(world):
    two, one = world["two"] / "data/eval/m", world["one"] / "data/eval/m"
    assert sorted(os.listdir(two)) == ["stats_ckpt.json", "stats_ep_ckpt_r0_w2.json",
                                       "stats_ep_ckpt_r1_w2.json"]
    assert (two / "stats_ckpt.json").read_text() == (one / "stats_ckpt.json").read_text()
    per_rank = [json.loads((two / f"stats_ep_ckpt_r{r}_w2.json").read_text()) for r in (0, 1)]
    assert [sorted(p, key=int) for p in per_rank] == [["0", "2", "4", "6"], ["1", "3", "5", "7"]]
    whole = json.loads((one / "stats_ep_ckpt_r0_w1.json").read_text())
    assert {**per_rank[0], **per_rank[1]} == whole


def test_merged_preds_equal_one_process(world):
    got = (world["two"] / "data/eval/m_preds.json").read_text()
    assert got == (world["one"] / "data/eval/m_preds.json").read_text()
    assert list(json.loads(got)) == ["0", "1", "2", "3"]


def test_merged_rxr_file_equals_one_process(world):
    got = (world["two"] / "rxr_w2.jsonl").read_text()
    assert got == (world["one"] / "rxr_w1.jsonl").read_text()
    assert [json.loads(line)["instruction_id"] for line in got.splitlines()] == [
        "ep0", "ep1", "ep2"]
    for paths in [r for r in world["ranks"]]:
        assert paths == world["single"]
