"""The runway's tools in the port, on the tiny configs: the conversion CLI
(``dynam3d_torch.tools.convert_reference_ckpt``), the parity run
(``tools.parity_run``) and its ``run_episode`` against the JAX package's,
and the eval soak on converted weights.

* the CLI converts seven ``.pth`` assets written by ``torch.save`` into
  ``ckpt.iter0``, which ``load_checkpoint`` reads back equal to the trees
  they were synthesized from;
* ``parity_run --synth --synth-dir`` gives every family back exactly, and
  its first-step logits dump ranks the first generated id first;
* the port's and the JAX ``run_episode`` (2 steps, dense bf16 Phi-3) on
  each package's conversion of the same synthesized state dicts give
  identical action ids at every step;
* ``eval_soak --converted`` runs a full tiny episode on the checkpoint."""

import dataclasses
import json
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import convert_reference_ckpt as jtool  # noqa: E402
import parity_run as jparity  # noqa: E402

from dynam3d_tpu.models import policy as jpolicy  # noqa: E402
from dynam3d_tpu.runtime import synth_sd as jsynth  # noqa: E402
from dynam3d_tpu.runtime.feed import SyntheticRoomFeed as JFeed  # noqa: E402
from dynam3d_torch.models import policy as tpolicy  # noqa: E402
from dynam3d_torch.runtime import synth_sd  # noqa: E402
from dynam3d_torch.runtime.checkpoint import load_checkpoint  # noqa: E402
from dynam3d_torch.runtime.feed import SyntheticRoomFeed as TFeed  # noqa: E402
from dynam3d_torch.tools import convert_reference_ckpt as ttool  # noqa: E402
from dynam3d_torch.tools import parity_run as tparity  # noqa: E402
from dynam3d_torch.tools.parity_run import with_identity_tail  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_trees_identical, port_config, reference_layout, runway_world,
)

ASSETS = ("dynam3d", "pretrain", "clip", "llava", "fastsam", "waypoint", "ddppo")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The port's synthesized assets of the runway world as ``.pth`` files,
    converted by the CLI; returns the trees and the checkpoint's path."""
    _, tcfg, trees, _, _ = runway_world()
    root = tmp_path_factory.mktemp("runway")
    sds = synth_sd.synth_all(trees["params"], tcfg, render_params=trees["render"],
                             waypoint_params=trees["waypoint"], depth_params=trees["depth_enc"])
    argv = ["--out", str(root / "converted")]
    for name in ASSETS:
        path = root / f"{name}.pth"
        torch.save(sds[name], path)
        argv += [f"--{name}", str(path)]
    cfg = dataclasses.asdict(tcfg)
    cfg["waypoint"].pop("nms_sigma")                  # a tuple: JSON has none
    (root / "cfg.json").write_text(json.dumps(cfg))
    out = ttool.main(argv + ["--exp-config", str(root / "cfg.json")], device="cpu")
    return trees, out


def test_convert_cli_writes_a_loadable_checkpoint(converted):
    trees, out = converted
    assert out["report"] == {"fields": "pretrain", "render": "pretrain", "clip": "clip",
                             "llava": "llava", "yolo": "fastsam", "waypoint": "waypoint",
                             "depth_enc": "ddppo"}
    assert os.path.basename(out["path"]) == "ckpt.iter0"
    ck = load_checkpoint(out["path"])
    assert sorted(ck) == ["depth_enc", "params", "render", "waypoint"]
    for part in ("fields", "clip", "yolo"):
        assert_trees_identical(ck["params"][part], trees["params"][part], part)
    assert_trees_identical(ck["params"]["llava"],
                           with_identity_tail(trees["params"]["llava"], ck["params"]["llava"]))
    for part in ("render", "waypoint", "depth_enc"):
        assert_trees_identical(ck[part], trees[part], part)


def test_eval_soak_runs_on_converted_weights(converted, tmp_path, monkeypatch):
    """A full-length tiny soak episode on the converted checkpoint: its
    ``fields`` are the converted ones, and the report names the file."""
    from dynam3d_torch.runtime import vln_loop
    from dynam3d_torch.tools import eval_soak

    trees, out = converted
    seen = {}
    evaluate = vln_loop.evaluate

    def recording(params, *a, **k):
        seen["fields"] = params["fields"]
        return evaluate(params, *a, **k)

    monkeypatch.setattr(vln_loop, "evaluate", recording)
    rep = eval_soak.main(["--scale", "tiny", "--out", str(tmp_path / "soak"), "--episodes", "1",
                          "--converted", out["path"]], device="cpu")
    assert rep["weights"] == out["path"] and rep["episodes"] == 1 and rep["steps"] == 50
    assert all(math.isfinite(v) for v in rep["metrics"].values())
    assert_trees_identical(seen["fields"], trees["params"]["fields"])


def _steps(path):
    return [json.loads(line) for line in open(path)]


def test_parity_run_synth_cli(tmp_path):
    """``parity_run --synth --synth-dir``: every family back exactly
    through ``.pth`` files, a 2-step episode dumped, and the first step's
    logits ranking its first generated id first."""
    rep = tparity.main(["--out", str(tmp_path / "port"), "--synth", "--synth-dir",
                        str(tmp_path / "assets"), "--scale", "tiny", "--steps", "2",
                        "--quant-bits", "0", "--dump-logits"], device="cpu")
    assert rep["roundtrip_max_abs_diff"] == {"fields": 0.0, "clip": 0.0, "llava": 0.0,
                                             "yolo": 0.0}
    assert sorted(os.listdir(tmp_path / "assets")) == ["clip.pth", "dynam3d.pth",
                                                       "fastsam.pth", "llava.pth"]
    steps = _steps(tmp_path / "port" / "steps_parity.jsonl")
    assert rep["steps"] == len(steps) == 2
    first = steps[0]["logits_top10"]
    assert len(first) == 10 and int(next(iter(first))) == steps[0]["action_ids"][0]
    agg = json.loads((tmp_path / "port" / "stats_parity.json").read_text())
    assert agg == rep["metrics"] and all(math.isfinite(v) for v in agg.values())


def test_episode_ids_match_the_reference(tmp_path, monkeypatch):
    """The same synthesized state dicts through each package's converter
    and ``run_episode`` (2 steps, dense bf16 Phi-3; one prefill bucket
    covers both prompts, so the reference compiles its step once):
    identical action ids and text at each step."""
    jcfg = jparity._config("tiny", 2)
    jcfg = dataclasses.replace(jcfg, llava=dataclasses.replace(jcfg.llava, prefill_bucket=384))
    tcfg = port_config(jcfg)
    truth = tpolicy.init_policy_params(0, tcfg, device="cpu")
    jt = reference_layout(truth)
    monkeypatch.setattr(jpolicy, "init_policy_params", lambda *a, **k: dict(jt))
    sds = jsynth.synth_all(jt, jcfg)
    paths = {k: sds[k] for k in ("dynam3d", "llava", "clip", "fastsam")}
    jp, _, _ = jtool.convert(jcfg, paths)
    tp, _, _ = ttool.convert(tcfg, {k: {n: torch.from_numpy(v) for n, v in sd.items()}
                                    for k, sd in paths.items()}, device="cpu")
    for name, fn, p in (("jax", jparity.run_episode, jp), ("port", tparity.run_episode, tp)):
        (tmp_path / name).mkdir()
        kw = {"device": "cpu"} if name == "port" else {}
        fn(p, jcfg if name == "jax" else tcfg, (JFeed if name == "jax" else TFeed)(
            rgb_size=56, depth_size=32, views=1), str(tmp_path / name), 2, **kw)
    ref, port = (_steps(tmp_path / n / "steps_parity.jsonl") for n in ("jax", "port"))
    assert len(port) == len(ref) == 2
    assert [s["prompt_padded_len"] for s in port] == [384, 384]
    assert [s["action_ids"] for s in port] == [s["action_ids"] for s in ref]
    assert [s["action_text"] for s in port] == [s["action_text"] for s in ref]


