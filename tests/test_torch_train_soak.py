"""The port's training soak (``dynam3d_torch.tools.train_soak``) at ``--scale
tiny`` on the CPU: 4 IL steps and 2 pretraining iterations, each phase in
its own process, the IL resume check in a third.

* every row carries the keys of the reference tool's row of the same
  phase (read from ``tools/train_soak.py``'s dict literals), the port's
  pretraining rows adding ``launches`` and ``plain_calls``;
* the IL resume check, in its fresh process, reproduces the probe's loss
  bit for bit (``"bit_compatible": true``), resuming at the midpoint;
* the pretraining resume reproduces its probe's loss bit for bit;
* losses are finite, and the first IL step is marked as a new shape.
"""

import ast
import json
import math
from pathlib import Path

from dynam3d_torch.tools import train_soak

ROOT = Path(__file__).resolve().parents[1]


def _reference_keys():
    """phase -> the constant keys of each row dict of the reference tool,
    one set a dict (a ``**`` spread adds the step's metrics, checked
    separately; ``il_resume_check`` has a second, error row)."""
    keys = {}
    tree = ast.parse((ROOT / "tools" / "train_soak.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            names = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "phase" in names:
                phase = node.values[names.index("phase")]
                if isinstance(phase, ast.Constant):
                    keys.setdefault(phase.value, []).append(set(names))
    return keys


def test_tiny_soak_rows_and_resume(tmp_path):
    out = tmp_path / "soak.jsonl"
    rc = train_soak.main(["--out", str(out), "--scale", "tiny", "--il-steps", "4",
                          "--pretrain-iters", "2", "--frames", "2",
                          "--workdir", str(tmp_path / "wd")], device="cpu")
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    by = {}
    for r in rows:
        by.setdefault(r["phase"], []).append(r)
    ref = _reference_keys()
    assert sorted(by) == sorted(ref) == sorted(
        ["meta", "il", "il_resume_check", "il_summary", "pretrain", "pretrain_resume_check",
         "pretrain_summary"])
    metrics = {"sim_loss", "segm_loss", "render_loss", "lang_loss", "text_loss", "loss",
               "skipped"}
    for phase, rs in by.items():
        extra = metrics | {"launches", "plain_calls"} if phase == "pretrain" else set()
        for r in rs:
            assert any(set(r) == want | extra for want in ref[phase]), (phase, sorted(r))
    assert len(by["meta"]) == 2 and len(by["il"]) == 4 and len(by["pretrain"]) == 2
    assert all(math.isfinite(r["loss"]) for r in by["il"] + by["pretrain"])
    assert [r["compile"] for r in by["il"]][0] is True
    il_check, = by["il_resume_check"]
    assert il_check["bit_compatible"] is True and il_check["resumed_iter"] == 2
    assert il_check["loss_after"] == il_check["loss_before"]
    pre_check, = by["pretrain_resume_check"]
    assert pre_check["bit_compatible"] is True
    assert pre_check["loss_after"] == pre_check["loss_before"]
    assert by["il_summary"][0]["steps"] == 4 and by["pretrain_summary"][0]["iters"] == 2
