"""The port's command-line entry (``dynam3d_torch.run.main``) against the
reference's (``dynam3d_tpu.run.main``) at the tiny slice config, each run
in its own working directory (the CLIs write ``data/...`` there).

The config goes in through ``--exp-config`` (a JSON file) plus dotted
options; the tuple field ``waypoint.nms_sigma`` is given as an ``a,b``
option (a JSON list would land as a list in both packages).  Each
package's parameter initialiser is replaced by the same JAX weights
(float32 Phi-3), converted with ``params_from_jax`` for the port: the one
place where the CLIs differ by design, since their random initialisers do.

* eval (6 box rooms + 2 floorplans) and inference (4 rooms): the same
  JSON text in every file, from feeds drawn with the same seeds;
* train: one iteration writes ``ckpt.iter1``; with ``train.is_requeue``
  the next run resumes from it; at ``WORLD_SIZE`` > 1 training raises;
* SS-ETP: the same datasets with the same seeds and generator states, and
  one port iteration logs finite losses;
* ``profiling``: ``StepTimer.stats()`` equals the reference's on the same
  durations, ``trace`` writes a Chrome trace on the CPU;
* ``tools.eval_soak`` at ``--scale tiny`` writes its report.
"""

import dataclasses
import json
import logging
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dynam3d_tpu import config as jconfig
from dynam3d_tpu import run as jrun
from dynam3d_tpu.models import policy as jpolicy
from dynam3d_tpu.runtime import episode as jepisode
from dynam3d_tpu.runtime import pretrain_loop as jpre
from dynam3d_tpu.runtime import vln_loop as jloop
from dynam3d_torch import run as trun
from dynam3d_torch.models import policy as tpolicy
from dynam3d_torch.runtime import pretrain_loop as tpre
from dynam3d_torch.runtime import vln_loop as tloop
from tests.torch_parity import slice_config, to_torch

OPTS = ["train.max_traj_len=3", "waypoint.nms_sigma=7.0,5.0"]
EVAL_FILES = ["stats_ckpt.json", "stats_ep_ckpt_r0_w1.json"]


def _write_config(path, jcfg):
    d = dataclasses.asdict(jcfg)
    assert d["waypoint"].pop("nms_sigma") == (7.0, 5.0)
    path.write_text(json.dumps(d))
    return str(path)


def _feed_record(feeds):
    return [(type(f).__name__, f.rgb_size, f.depth_size, f.views, f.rng.bit_generator.state)
            for f in feeds]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs' eval and then inference, each package in its own working
    directory; the reference's two runs share one ``EpisodeRunner`` so its
    step compiles once.  Returns the directories and the feeds each
    package's ``evaluate`` / ``inference`` got."""
    root = tmp_path_factory.mktemp("cli")
    jcfg = slice_config()
    cfg_path = _write_config(root / "cfg.json", jcfg)
    jp = jpolicy.init_policy_params(jax.random.PRNGKey(0), jcfg, llm_dtype=jnp.float32)
    shared = jepisode.EpisodeRunner(jp, jconfig.apply_opts(jconfig.load(cfg_path), OPTS))

    class Shared(jepisode.EpisodeRunner):
        def __new__(cls, *a, **k):
            return shared

    feeds = {"jax": {}, "torch": {}}
    mp = pytest.MonkeyPatch()

    def recording(name, mod, fn):
        orig = getattr(mod, fn)

        def wrapped(params, cfg, fs, *a, **k):
            feeds[name][fn] = _feed_record(fs)
            return orig(params, cfg, fs, *a, **k)

        mp.setattr(mod, fn, wrapped)

    try:
        mp.setattr(jepisode, "EpisodeRunner", Shared)
        mp.setattr(jpolicy, "init_policy_params", lambda *a, **k: jp)
        mp.setattr(tpolicy, "init_policy_params", lambda *a, **k: to_torch(jp))
        for name, mod in (("jax", jloop), ("torch", tloop)):
            for fn in ("evaluate", "inference"):
                recording(name, mod, fn)
        for name, main, kw in (("jax", jrun.main, {}), ("torch", trun.main, {"device": "cpu"})):
            d = root / name
            d.mkdir()
            mp.chdir(d)
            for run_type in ("eval", "inference"):
                main(["--exp-config", cfg_path, "--run-type", run_type, "--exp_name", "demo",
                      "--seed", "3"] + OPTS, **kw)
    finally:
        mp.undo()
        for h in list(logging.getLogger("dynam3d_tpu").handlers):
            logging.getLogger("dynam3d_tpu").removeHandler(h)
            h.close()
    return root, feeds


@pytest.mark.parametrize("name", EVAL_FILES + ["preds"])
def test_eval_and_inference_files_are_identical(cli_runs, name):
    root, _ = cli_runs
    rel = "data/eval/demo_preds.json" if name == "preds" else f"data/eval/demo/{name}"
    t = (root / "torch" / rel).read_text()
    assert t == (root / "jax" / rel).read_text()
    if name == "stats_ep_ckpt_r0_w1.json":
        per_ep = json.loads(t)
        assert sorted(per_ep, key=int) == [str(i) for i in range(8)]
        assert all(1 <= e["steps_taken"] <= 3 for e in per_ep.values())
    if name == "preds":
        assert sorted(json.loads(t)) == ["0", "1", "2", "3"]


def test_the_same_feeds_are_drawn(cli_runs):
    _, feeds = cli_runs
    assert feeds["torch"] == feeds["jax"]
    ev = feeds["torch"]["evaluate"]
    assert [f[0] for f in ev] == ["SyntheticRoomFeed"] * 6 + ["FloorplanFeed"] * 2
    assert all(f[1:4] == (336, 256, 1) for f in ev)
    assert len(feeds["torch"]["inference"]) == 4
    assert len({str(f[4]) for f in ev[:6]}) == 6          # six different seeds


def test_run_log_and_handlers(cli_runs, tmp_path, monkeypatch):
    root, _ = cli_runs
    lines = (root / "torch" / "data/logs/running_log/demo.log").read_text().splitlines()
    assert len(lines) == 3 and "type=eval" in lines[0] and "eval: {" in lines[1]
    monkeypatch.chdir(tmp_path)
    logger = logging.getLogger("dynam3d_torch")
    for name in ("a", "b"):
        trun.setup_logging(name)
    assert len([h for h in logger.handlers if getattr(h, "_dynam3d_run", False)]) == 2
    logger.info("one line")
    assert (tmp_path / "data/logs/running_log/b.log").read_text().count("one line") == 1
    assert "one line" not in (tmp_path / "data/logs/running_log/a.log").read_text()
    for h in [h for h in logger.handlers if getattr(h, "_dynam3d_run", False)]:
        logger.removeHandler(h)
        h.close()


def test_parsers_agree():
    for argv in (["--run-type", "eval"],
                 ["--run-type", "train", "--trainer", "SS-ETP", "--exp_name", "x", "--seed", "4",
                  "--ckpt-dir", "ck", "--exp-config", "c.yaml", "train.iters=2", "mesh.dp=1"]):
        assert vars(trun.build_parser().parse_args(argv)) == vars(
            jrun.build_parser().parse_args(argv))
    assert sorted(trun.TRAINER_REGISTRY) == sorted(jrun.TRAINER_REGISTRY)


def test_eval_shards_by_rank(tmp_path, monkeypatch):
    """Eval as rank 1 of 2 (torchrun's variables) runs episodes 1, 3, 5, 7
    and writes its own stats file; no process group is needed."""
    jcfg = slice_config()
    cfg_path = _write_config(tmp_path / "cfg.json", jcfg)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    trun.main(["--exp-config", cfg_path, "--run-type", "eval", "--exp_name", "r"] + OPTS +
              ["train.max_traj_len=1"], device="cpu")
    per_ep = json.loads((tmp_path / "data/eval/r/stats_ep_ckpt_r1_w2.json").read_text())
    assert sorted(per_ep, key=int) == ["1", "3", "5", "7"]
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        trun.main(["--exp-config", cfg_path, "--run-type", "train"], device="cpu")


def test_train_writes_a_checkpoint_and_resumes(tmp_path, monkeypatch):
    """``train.iters=1`` trains one episode and saves ``ckpt.iter1``; a
    requeued run with ``train.iters=2`` resumes at step 1 and trains one
    more episode."""
    jcfg = slice_config()
    cfg_path = _write_config(tmp_path / "cfg.json", jcfg)
    monkeypatch.chdir(tmp_path)
    resumed, episodes = [], []
    resume, train_episode = tloop.VLNTrainer.resume, tloop.VLNTrainer.train_episode
    monkeypatch.setattr(tloop.VLNTrainer, "resume",
                        lambda self, d: resumed.append(resume(self, d)) or resumed[-1])
    monkeypatch.setattr(tloop.VLNTrainer, "train_episode",
                        lambda self, *a, **k: episodes.append(train_episode(self, *a, **k))
                        or episodes[-1])
    base = ["--exp-config", cfg_path, "--run-type", "train", "--exp_name", "il",
            "train.max_traj_len=2", "train.log_every=1", "train.use_waypoint_predictor=false"]
    trun.main(base + ["train.iters=1"], device="cpu")
    assert os.listdir(tmp_path / "data/checkpoints") == ["ckpt.iter1"]
    assert resumed == [] and len(episodes) == 1 and math.isfinite(episodes[0]["loss"])
    trun.main(base + ["train.iters=2", "train.is_requeue=true"], device="cpu")
    assert resumed == [1] and len(episodes) == 2


def _pretrain_config():
    """The reference walk tests' tiny fields, render and CLIP with the
    slice config's tiny depth encoder and waypoint predictor."""
    from tests.test_torch_pretrain_loop import CFG

    tiny = slice_config()
    return dataclasses.replace(CFG, depth=tiny.depth, waypoint=tiny.waypoint)


def test_ss_etp_dispatches_the_same_datasets(tmp_path, monkeypatch):
    jcfg = _pretrain_config()
    cfg_path = _write_config(tmp_path / "cfg.json", jcfg)
    got = {}

    def capture(name):
        def run(self, datasets, iters, logger=None, ckpt_dir=None, log_every=100):
            got[name] = dict(seed=self.seed, iters=iters, ckpt_dir=ckpt_dir,
                             log_every=log_every, logger=os.path.relpath(logger.path),
                             datasets=datasets)
            return []
        return run

    # the dispatch is under test, not the weights: the reference's eager
    # initialisers (~17 s here) are stubbed
    from dynam3d_tpu.models.encoders import clip, depth_resnet
    from dynam3d_tpu.models import memory3d
    from dynam3d_tpu.models.render import nerf
    from dynam3d_tpu.models.waypoint import trm

    for mod, fn in ((clip, "init_clip_params"), (depth_resnet, "init_depth_params"),
                    (memory3d, "init_field_params"), (nerf, "init_render_params"),
                    (trm, "init_waypoint_params")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: {})
    monkeypatch.setattr(depth_resnet, "encode_depth", lambda p, c, d: jnp.zeros((1, 8)))
    monkeypatch.setattr(jpre.PretrainRunner, "run", capture("jax"))
    monkeypatch.setattr(tpre.PretrainRunner, "run", capture("torch"))
    argv = ["--exp-config", cfg_path, "--run-type", "train", "--trainer", "SS-ETP",
            "--exp_name", "pre", "train.iters=7", "train.seed=5"] + OPTS[1:]
    for name, main, kw in (("jax", jrun.main, {}), ("torch", trun.main, {"device": "cpu"})):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(argv, **kw)
    for h in list(logging.getLogger("dynam3d_tpu").handlers):
        logging.getLogger("dynam3d_tpu").removeHandler(h)
        h.close()
    j, t = got["jax"], got["torch"]
    assert {k: j[k] for k in j if k != "datasets"} == {k: t[k] for k in t if k != "datasets"}
    assert t["seed"] == 5 and t["iters"] == 7
    assert t["logger"] == os.path.join("data", "logs", "pre", "scalars.jsonl")
    assert [type(d).__name__ for d in t["datasets"]] == [type(d).__name__ for d in j["datasets"]]
    (jw, jf, jp), (tw, tf, tp) = j["datasets"], t["datasets"]
    for a in ("nv", "max_len", "teacher_prob", "stop_distance", "waypoint_aug"):
        assert getattr(tw, a) == getattr(jw, a), a
    assert tw.rng.bit_generator.state == jw.rng.bit_generator.state
    assert _feed_record([tw.feed]) == _feed_record([jw.feed])
    assert tw.feed.views == 12 and tw.feed.depth_size == jcfg.depth.input_size
    assert sorted(tw.sup) == sorted(jw.sup)
    for k in tw.sup:
        np.testing.assert_array_equal(tw.sup[k], np.asarray(jw.sup[k]), err_msg=k)
    for a, b in ((tf, jf), (tp, jp)):
        assert (a.posed, a.frames, a.use_labels, a.depth_size) == (b.posed, b.frames,
                                                                   b.use_labels, b.depth_size)
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
        assert _feed_record([a._feed]) == _feed_record([b._feed])
    assert (tf.posed, tp.posed) == (False, True)


def test_ss_etp_one_port_iteration_logs_finite_losses(tmp_path, monkeypatch):
    cfg_path = _write_config(tmp_path / "cfg.json", _pretrain_config())
    monkeypatch.chdir(tmp_path)
    trun.main(["--exp-config", cfg_path, "--run-type", "train", "--trainer", "SS-ETP",
               "--exp_name", "pre", "train.iters=1"] + OPTS[1:], device="cpu")
    rows = [json.loads(r) for r in (tmp_path / "data/logs/pre/scalars.jsonl").open()]
    assert rows and {r["step"] for r in rows} == {0}
    assert all(r["tag"].startswith("loss/") and math.isfinite(r["value"]) for r in rows)
    assert any(r["tag"] == "loss/loss" for r in rows)


def test_step_timer_stats_match_the_reference(tmp_path):
    from dynam3d_tpu.runtime import profiling as jprof
    from dynam3d_torch.runtime import profiling as tprof

    durations = list(np.random.default_rng(0).uniform(0.001, 0.2, 37))
    t, j = tprof.StepTimer("step"), jprof.StepTimer("step")
    assert t.stats() == j.stats() == {}
    t.samples, j.samples = list(durations), list(durations)
    assert t.stats() == j.stats()
    assert set(t.stats()) == {"name", "n", "p50_ms", "p90_ms", "mean_ms"}
    with t:
        pass
    assert len(t.samples) == 38 and 0 <= t.samples[-1] < 1.0
    t.dump(str(tmp_path / "t.jsonl"))
    t.dump(str(tmp_path / "t.jsonl"))
    rows = [json.loads(r) for r in (tmp_path / "t.jsonl").open()]
    assert rows == [t.stats()] * 2


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    from dynam3d_torch.runtime import profiling

    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        y = (x @ x).sum()
        profiling.sync({"a": [y]})
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "tr" / files[0]).read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_eval_soak_tiny_writes_a_report(tmp_path):
    from dynam3d_torch.tools import eval_soak

    out = tmp_path / "soak"
    rep = eval_soak.main(["--scale", "tiny", "--out", str(out), "--episodes", "2"],
                         device="cpu")
    saved = json.loads((out / "soak_report.json").read_text())
    assert saved == json.loads(json.dumps(rep))
    assert rep["device"] == "cpu" and rep["quant_bits"] == 4 and rep["episodes"] == 2
    assert rep["steps"] == 100                            # two full 50-step episodes
    assert rep["ms_per_step"] > 0 and math.isfinite(rep["s_per_episode"])
    assert all(math.isfinite(v) for v in rep["metrics"].values())
    per_ep = json.loads((out / "stats_ep_soak_r0_w1.json").read_text())
    assert sorted(per_ep) == ["0", "1"]
