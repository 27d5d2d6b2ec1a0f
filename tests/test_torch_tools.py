"""The port's profiling and A/B tools against the JAX package's, on the CPU
(the decode tools' parity and the compile-check entry:
``test_torch_tools_decode.py``):

* ``spec_acceptance``: ``simulate`` and ``run_granularity`` equal the JAX
  tool's (imported as ``tests/test_spec_acceptance.py`` imports it, its
  drafting function jitted: the same integer ops, traced once a shape
  instead of dispatched op by op) for every scenario, both granularities
  and draft lengths 2, 4 and 8, and the whole report: exactly;
* ``copycheck``: the port's report equals the JAX tool's on fixture trees
  (one copied file flagged, one edited below the threshold, one under
  ``tests/`` that the skip list drops; ``REPO`` and ``REF`` patched in the
  JAX tool): exactly, and the exit codes;
* ``parity_run --llm-layers 1`` (and ``eval_soak.soak_config``): the
  tree and the episode at that depth;
* ``train_soak``: a resume-check child that fails gives a non-zero exit
  code and a ``"bit_compatible": false`` row;
* each card tool raises without a card unless asked for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from dynam3d_tpu.models.vlm import phi3 as jphi3
from dynam3d_torch.tools import copycheck as tcopy
from dynam3d_torch.tools import spec_acceptance as tspec

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)

import copycheck as jcopy  # noqa: E402
import spec_acceptance as jspec  # noqa: E402


# --- spec_acceptance ------------------------------------------------------

@pytest.fixture
def jit_drafts(monkeypatch):
    monkeypatch.setattr(jphi3, "_ngram_draft", jax.jit(jphi3._ngram_draft, static_argnums=(6,)))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_spec_acceptance_equals_the_jax_tool(k, jit_drafts):
    from dynam3d_tpu.models.vlm.tokenizer import ByteTokenizer as JTok
    from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer as TTok

    assert tspec.SCENARIOS == jspec.SCENARIOS and tspec.INSTRUCTIONS == jspec.INSTRUCTIONS
    for jtok, ttok in ((JTok(32064), TTok(32064)),
                       (jspec._WordProxyTokenizer(), tspec.WordProxyTokenizer())):
        assert tspec.run_granularity(ttok, k) == jspec.run_granularity(jtok, k)
        for _, history, cont in jspec.SCENARIOS:
            ids = ttok.encode("go " + "".join(history))
            c = ttok.encode(cont + "<|end|>", add_bos=False)
            assert tspec.simulate(np.asarray(ids), c, k) == jspec.simulate(
                np.asarray(ids, np.int32), c, k)


def test_spec_acceptance_report_equals_the_jax_tool(capsys, jit_drafts):
    assert tspec.main(["--json"]) == jspec.main(["--json"])


# --- copycheck ---------------------------------------------------------------

def _lines(seed, n=40):
    rng = np.random.default_rng(seed)
    return [f"value_{i} = compute({int(rng.integers(0, 10**6))}, {i})" for i in range(n)]


def test_copycheck_report_equals_the_jax_tool(tmp_path, monkeypatch, capsys):
    repo, ref = tmp_path / "repo", tmp_path / "ref"
    for d in (repo / "pkg", repo / "tests", ref / "src"):
        d.mkdir(parents=True)
    base, other = _lines(0), _lines(1, 60)
    (ref / "src" / "model.py").write_text("\n".join(base))
    (ref / "src" / "loop.py").write_text("\n".join(other))
    (repo / "pkg" / "model.py").write_text("\n".join(base[:36] + _lines(2, 4)))    # flagged
    (repo / "pkg" / "loop.py").write_text("\n".join(other[:20] + _lines(3, 40)))   # below
    (repo / "tests" / "model.py").write_text("\n".join(base))                      # skipped
    (repo / "pkg" / "short.py").write_text("\n".join(base[:10]))                   # < 30 lines
    monkeypatch.setattr(jcopy, "REPO", str(repo))
    monkeypatch.setattr(jcopy, "REF", str(ref))
    rc_j = jcopy.main(["--json"])
    want = json.loads(capsys.readouterr().out)
    rc_t = tcopy.main(["--repo", str(repo), "--reference", str(ref), "--json"])
    got = json.loads(capsys.readouterr().out)
    assert got == want and rc_t == rc_j == 1
    assert [f["file"] for f in got["flagged"]] == [os.path.join("pkg", "model.py")]
    assert got["checked"] == 2
    (repo / "pkg" / "model.py").unlink()
    assert tcopy.main(["--repo", str(repo), "--reference", str(ref)]) == 0


# --- parity_run --llm-layers -------------------------------------------------

def test_parity_run_llm_layers(tmp_path):
    from dynam3d_torch.tools import parity_run
    from dynam3d_torch.tools.eval_soak import soak_config

    assert soak_config("full").llava.phi3.num_layers == 32
    assert soak_config("tiny").llava.phi3.num_layers == 2
    assert soak_config("full", 4).llava.phi3.num_layers == 4
    rep = parity_run.main(["--out", str(tmp_path), "--synth", "--scale", "tiny",
                           "--llm-layers", "1", "--steps", "2", "--quant-bits", "0"],
                          device="cpu")
    one = rep["policy_params_m"]
    rep2 = parity_run.main(["--out", str(tmp_path / "two"), "--synth", "--scale", "tiny",
                            "--steps", "1", "--no-episode", "--quant-bits", "0"], device="cpu")
    assert one < rep2["policy_params_m"]
    rows = [json.loads(r) for r in (tmp_path / "steps_parity.jsonl").open()]
    assert len(rows) == 2


# --- train_soak: a failing resume child ---------------------------------------

def test_train_soak_failing_child_exits_nonzero(tmp_path, monkeypatch):
    from dynam3d_torch.tools import train_soak

    real = subprocess.call

    def break_checkpoint(cmd, *a, **k):
        # the child finds no checkpoint and fails
        if "--il-resume-check" in cmd:
            import shutil

            shutil.rmtree(tmp_path / "wd" / "il_ckpt")
        return real(cmd, *a, **k)

    monkeypatch.setattr(train_soak.subprocess, "call", break_checkpoint)
    out = tmp_path / "soak.jsonl"
    rc = train_soak.main(["--out", str(out), "--scale", "tiny", "--il-steps", "2",
                          "--skip-pretrain", "--workdir", str(tmp_path / "wd")], device="cpu")
    rows = [json.loads(r) for r in out.read_text().splitlines()]
    check = [r for r in rows if r["phase"] == "il_resume_check"]
    assert rc != 0
    assert len(check) == 1 and check[0]["bit_compatible"] is False and "error" in check[0]
    assert json.loads((tmp_path / "wd" / "il_probe.json").read_text())["splice_start"] > 0


# --- no card -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["prof_decode_parts", "ab_fused_decode", "ab_spec_decode",
                                  "ab_spec_batched", "prof_prefill", "bench_int8_prefill",
                                  "profile_perceive", "prof_full_step"])
def test_card_tools_raise_without_a_card(name, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"dynam3d_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.main([])
