"""The check of the 3DFF pretraining cell: what the window's sampled
iterations produced, against the plain reference
(``reference/fields_ref.py``), after the window.

At each sampled iteration the entry kept the scene as the dataset gave it,
the trainable tree and the optimizer state before the step, the step's
batch, folded table, per-view byproducts, renders, losses, and the tree
and state after it.  The reference makes the same CLIP tower again from
the seed, starts from the program's trainable tree before the step (the
parameters are the program's running state; the reference follows it one
step at a time), and works the step out again.  The program's clipped
gradient is read from its new first moment and the old one:
``g = (mu' - b1 mu) / (1 - b1)``.

- ``clip_gap``: the largest relative L2 gap of the CLIP patch grids and
  CLS features of the frames;
- ``segm_off``, ``merges_off``, ``samples_off``, ``neighbours_off``:
  discrete choices that can tie within rounding, each the share that
  differs from the reference's own beyond a tie: neighbouring patch pairs
  that share a segment on one side only, segments' merge choices (a
  proposal or a new instance), rays whose 8 kept samples of 501 differ
  (in order: the first is the ray's position), kept samples whose
  neighbours differ (a set in an order: the slot each fills), and whether
  the category focal loss's hardest rays differ (1 or 0: each weighs many
  times another ray in the gradient).  The
  reference then takes the program's choice, so that a near-tie does not
  move every later slot (a symmetric scene puts two patches at one
  distance from the camera, the first sample of every ray);
- ``table_rows_off``: the share of live rows of the folded table
  (patches, instances, zones) whose features differ by more than the
  cell's ``row_tol`` of their norm, or that are live on one side only;
- ``render_rows_off``: the share of rendered rays whose feature differs by
  more than ``row_tol``, or whose first kept sample lies elsewhere (the
  importance top-8 of 501 samples and the neighbours at the radius can tie
  within rounding);
- ``loss_gap``: the largest relative gap over the five loss terms and
  their sum;
- ``grad_gap``: the largest relative L2 gap over the trainable leaves of
  the clipped gradient (a leaf whose reference gradient is under
  ``GRAD_FLOOR`` of the whole gradient's norm is held to that floor); the
  renderer's leaves set it, whose gradient moves with rounding through the
  category focal loss (its logits are 10 cosines against unnormalized
  caption features, and its hardest rays weigh many times another);
- ``grad_gap_fields``: the same over the memory's leaves alone
  (``fields/...``: the fold's encoders, which the backward reaches through
  the recomputed folds), held to its own, tighter limit;
- ``update_gap``: AdamW, the reference's, over the program's clipped
  gradient and state before the step, against the program's new
  parameters: the largest relative L2 gap of the step taken, over leaves.

The lower-precision control (``readings(..., control=True)``) puts the
reference one precision step down (fp8 matrix-product inputs where the
configuration states bf16, :mod:`fields_ref`) in the program's place, and
the full reference follows its discrete choices as it follows the
program's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import fields_ref as ref

COMPARED = ("clip_gap", "segm_off", "merges_off", "samples_off", "neighbours_off",
            "hardest_off", "table_rows_off", "render_rows_off", "loss_gap", "grad_gap",
            "grad_gap_fields", "update_gap")
FOLLOWED = ("segm", "is_merge", "owner", "neighbours", "hardest")
TERMS = ("sim_loss", "segm_loss", "render_loss", "lang_loss", "text_loss", "loss")
GRAD_FLOOR = 1e-4          # of the whole gradient's norm, a leaf's least denominator
POS_TOL = 1e-3             # metres: a ray's first kept sample elsewhere


def supervision(seed: int, it: int, n_cats: int, n_labels: int, dim: int) -> Dict:
    """The caption and category tables of iteration ``it`` as the
    configuration assumes them (``assumed.supervision``): drawn from
    ``numpy.random.default_rng(seed + it)``, categories then the id map
    then the captions."""
    rng = np.random.default_rng(seed + it)
    return {"cat": rng.normal(size=(n_cats, dim)).astype(np.float32),
            "gtid_to_cat": rng.integers(-1, n_cats, n_labels).astype(np.int32),
            "text": rng.normal(size=(n_labels, dim)).astype(np.float32),
            "text_valid": np.ones(n_labels, bool)}


def _rel(a: torch.Tensor, b: torch.Tensor, floor: float = 1e-30) -> float:
    if a.shape != b.shape:
        return math.inf
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=floor))


def _row_errors(a, b, va, vb) -> torch.Tensor:
    """Each live row's relative gap (infinite where live on one side only)."""
    if a.shape != b.shape:
        return torch.full((int(va.sum()) + int(vb.sum()),), math.inf)
    live = va | vb
    a, b = a[live].float(), b[live].float()
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-12)
    return torch.where(va[live] != vb[live], torch.full_like(rel, math.inf), rel).cpu()


def program_outputs(s: Dict, names: List[str], b1: float) -> Dict:
    """A sampled iteration of the program in the reference's terms."""
    batch, aux, st = s["batch"], s["aux"], s["state"]
    g = [((m1.double() - b1 * m0.double()) / (1 - b1)).float()
         for m1, m0 in zip(s["opt_after"]["mu"], s["opt_before"]["mu"])]
    return {"grid": batch.grid_fts, "cls": batch.cls_fts, "segm": batch.segm.long(),
            "is_merge": aux.base.is_merge, "owner": aux.base.owner,
            "neighbours": s["neighbours"], "hardest": ref.hardest(*s["focal"]),
            "table": {k: getattr(st, k) for k in st._fields},
            "renders": [(o.features.reshape(-1, o.features.shape[-1]).float(),
                         o.positions.reshape(-1, 3).float()) for o in s["renders"]],
            "losses": {k: float(s["metrics"][k]) for k in TERMS},
            "grads": g, "params_before": s["params_before"], "params_after": s["params_after"],
            "opt_before": s["opt_before"], "names": names}


def reference_outputs(out: Dict, params_before: List[torch.Tensor]) -> Dict:
    """A reference step (the control's) in the same terms."""
    aux = out["aux"]
    return {"grid": out["batch"]["grid"], "cls": out["batch"]["cls"], "segm": out["segm_own"],
            "is_merge": aux["is_merge"], "owner": aux["owner"],
            "neighbours": out["neighbours"], "hardest": out["hardest"], "table": out["table"],
            "renders": [(r[0], r[1]) for r in out["renders"]], "losses": out["losses"],
            "grads": out["grads"], "params_before": params_before,
            "params_after": out.get("params"), "opt_before": None, "names": out["names"]}


def compare(prog: Dict, out: Dict, row_tol: float, hp: Dict) -> Dict[str, float]:
    """The compared numbers of one iteration: the program's (or the
    control's) outputs ``prog`` against the reference's step ``out``."""
    b = out["batch"]
    r: Dict[str, float] = {}
    r["clip_gap"] = max(_rel(prog["grid"], b["grid"]), _rel(prog["cls"], b["cls"]))
    r["segm_off"] = out["segm_off"] / out["segm_pairs"] \
        if prog["segm"].shape == out["segm_own"].shape else 1.0
    same_v = prog["is_merge"].shape == out["aux"]["is_merge"].shape
    r["merges_off"] = out["merges_off"] / max(out["segments"], 1) if same_v else 1.0
    r["samples_off"] = out["samples_off"] / max(out["rays"], 1)
    r["hardest_off"] = out["hardest_off"]
    r["neighbours_off"] = out["neighbours_off"] / max(out["queries"], 1)
    errs = []
    for f, v in (("patch_fts", "patch_valid"), ("inst_fts", "inst_valid"),
                 ("zone_fts", "zone_valid")):
        errs.append(_row_errors(prog["table"][f], out["table"][f], prog["table"][v],
                                out["table"][v]))
    e = torch.cat(errs)
    r["table_rows_off"] = float((e > row_tol).sum()) / max(e.numel(), 1)
    off, rays = 0, 0
    for (pf, pp), (rf, rp, _) in zip(prog["renders"], out["renders"]):
        bad = ((pf - rf).norm(dim=-1) / rf.norm(dim=-1).clamp(min=1e-12) > row_tol) \
            | ((pp - rp).norm(dim=-1) > POS_TOL)
        off += int(bad.sum())
        rays += bad.numel()
    r["render_rows_off"] = off / max(rays, 1) if len(prog["renders"]) == len(out["renders"]) \
        else 1.0
    terms = {k: abs(prog["losses"][k] - out["losses"][k]) / max(abs(out["losses"][k]), 1e-3)
             for k in TERMS}
    r["loss_gap"] = max(terms.values())
    total = math.sqrt(sum(float(g.float().norm()) ** 2 for g in out["grads"]))
    gaps = {n: _rel(a, c, GRAD_FLOOR * total)
            for n, a, c in zip(out["names"], prog["grads"], out["grads"])}
    r["grad_gap"] = max(gaps.values())
    worst = max(gaps, key=gaps.get)
    r["update_gap"] = _update_gap(prog, hp) if prog.get("opt_before") is not None else 0.0
    r["_terms"] = terms
    r["_worst_leaf"] = worst
    r["grad_gap_fields"] = max(v for n, v in gaps.items() if n.startswith("fields/"))
    r["_grad_gap_render"] = max(v for n, v in gaps.items() if n.startswith("render/"))
    r["_raw_grad_max"] = out["raw_grad_max"]
    return r


def _update_gap(prog: Dict, hp: Dict) -> float:
    """The reference's AdamW over the program's clipped gradient and state
    before, against the program's new parameters."""
    ob = prog["opt_before"]
    skip = math.isnan(prog["losses"]["loss"])
    new, _ = ref.adamw(prog["grads"], {"count": ob["count"], "mu": ob["mu"], "nu": ob["nu"]},
                       prog["params_before"], hp, skip)
    gap = 0.0
    for p0, p1, q in zip(prog["params_before"], prog["params_after"], new):
        step = (q - p0).float().norm()
        gap = max(gap, float((p1 - q).float().norm() / step.clamp(min=1e-30))
                  if float(step) > 0 else float((p1 - q).float().norm() > 0))
    return gap


def readings(ctx, rcfg, samples: List[Dict], names: List[str], control: bool = False
             ) -> Dict[str, float]:
    """The compared numbers over the sampled iterations (the largest of
    each); ``control`` reads the lower-precision reference in the
    program's place instead of the program."""
    from perfbench import weights_fields

    dev = ctx.device
    chk = ctx.cell["check"]
    hp = ref.hyper(rcfg, ctx.config["optimizer"])
    clip = weights_fields.fields_params(ctx.seed, rcfg, dev)["clip"]
    got: Dict[str, float] = {}
    per: List[Dict] = []
    for s in samples:
        params = {"clip": clip, "fields": s["tree_before"]["fields"],
                  "render": s["tree_before"]["render"]}
        sup = supervision(s["sup_seed"], s["it"], chk["categories"], chk["labels"],
                          rcfg.fields.fts_dim)
        if control:
            low = ref.step(params, rcfg, s["scene"], sup, hp, s["opt_before"], low=True)
            prog = reference_outputs(low, s["params_before"])
            del low
        else:
            prog = program_outputs(s, names, hp["b1"])
        follow = {k: prog[k] for k in FOLLOWED}
        out = ref.step(params, rcfg, s["scene"], sup, hp, None, follow=follow)
        r = compare(prog, out, float(chk["row_tol"]), hp)
        per.append(r)
        for k in COMPARED:
            got[k] = max(got.get(k, 0.0), r[k])
        del out, prog
    got["iterations_checked"] = float(len(samples))
    got["_per_iteration"] = per
    return got


def judge(limits: Dict, got: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit (the cell file's ``limits``)."""
    out = {n: {"value": got[n], "limit": limits[n], "ok": bool(got[n] <= limits[n])}
           for n in COMPARED if n in got}
    if "iterations_checked" in got:
        n, least = got["iterations_checked"], limits["iterations_checked"]
        out["iterations_checked"] = {"value": n, "limit": least, "ok": n >= least}
    return out


def correct(limits: Dict, got: Dict[str, float]) -> bool:
    return all(c["ok"] for c in judge(limits, got).values())
