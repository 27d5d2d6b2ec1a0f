"""The check of the evaluation cells: what the window's steps produced,
against the plain reference, after the window.

At each sampled step the reference starts from the program's own memory
state before the step (the memory is the program's running state; the
reference follows it one step at a time) and the step's inputs, and works
out again, with ``reference/perception.py`` and the reference's own
weights (the same seed's tree, made again):

- the step's fold and multimodal tokens: ``memory_rows_off`` is the share
  of live memory rows (patches, instances, zones) whose features differ by
  more than the cell's ``row_tol`` of their norm from the reference's, or
  whose slot is live on one side only; ``mm_rows_off`` the same share over
  the multimodal token rows (the shares at ``TOLS`` are read beside them);
- the start: ``start_state_off`` counts the entries of the program's memory
  before the first step of an episode that differ from the reference's
  empty table;
- the prompt ids (its own tokenizer over the cell's instruction and the
  history the episode's served ids give): ``prompt_ids_off`` counts ids
  that differ;
- Phi-3 over the prompt and the served ids (``reference/phi3_ref.py``, the
  served int8 / int4 weights derived again, float32): ``logit_gap`` is the
  widest gap by which a served token's logit lies below the reference's
  best at its position.

The lower-precision control (``readings(..., control=True)``) puts the
reference in the program's place one precision step down: fp8 for the
perception weights that compute in bf16, bf16 for those in float32, int4
for the prompt's W8A8 and int3 for the int4 decode weights; ``judge``
holds its numbers against the same limits.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench import weights
from perfbench.reference import perception as ref
from perfbench.reference import phi3_ref
from perfbench.reference.tokenizer import ByteTokenizer, build_prompt, histories

TOLS = (0.01, 0.02, 0.03, 0.05, 0.1)     # row tolerances whose shares are read
COMPARED = ("start_state_off", "memory_rows_off", "mm_rows_off", "prompt_ids_off", "logit_gap")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _row(state, row: int) -> ref.State:
    """One row of a batched memory state, read by field name."""
    return ref.State(*(getattr(state, k)[row] for k in ref.State._fields))


def served_len(gen, end_id: int) -> int:
    """Tokens a step served: up to its first end token, that included."""
    return gen.index(end_id) + 1 if end_id in gen else len(gen)


def _row_errors(a: torch.Tensor, b: torch.Tensor, va: torch.Tensor,
                vb: torch.Tensor) -> torch.Tensor:
    """Each live row's relative gap of two ``[N, D]`` tables (infinite
    where the row is live on one side only)."""
    live = va | vb
    a, b = a[live].float(), b[live].float()
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-12)
    return torch.where(va[live] != vb[live], torch.full_like(rel, float("inf")), rel).cpu()


def _memory_errors(prog, ref_state) -> torch.Tensor:
    return torch.cat([_row_errors(getattr(prog, f), getattr(ref_state, f), getattr(prog, v),
                                  getattr(ref_state, v))
                      for f, v in (("patch_fts", "patch_valid"), ("inst_fts", "inst_valid"),
                                   ("zone_fts", "zone_valid"))])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp(min=1e-12) / 448.0
    return ((t / s).to(torch.float8_e4m3fn).to(t.dtype) * s).to(t.dtype)


def control_params(params: Dict) -> Dict:
    """The perception weights one precision step down: fp8 (per-tensor
    scale) for the modules that compute in bf16 (both CLIP towers, the
    projector, the memory's encoders), bf16 for the float32 rest."""
    out = dict(params)
    for key in ("clip", "fields"):
        out[key] = tree_map(lambda t: _fp8(t) if t.is_floating_point() else t,
                                    params[key])
    out["llava"] = dict(params["llava"])
    for key in ("clip", "projector"):
        out["llava"][key] = tree_map(lambda t: _fp8(t) if t.is_floating_point()
                                             else t, params["llava"][key])
    for key in [k for k in params if k not in ("clip", "fields", "llava")]:
        out[key] = tree_map(
            lambda t: t.to(torch.bfloat16).to(t.dtype) if t.is_floating_point() else t,
            params[key])
    return out


def perception_flops(seed: int, rcfg, dev) -> float:
    """Model FLOPs of one view's perception: the segmenter, the grid CLIP
    tower and LLaVA's tower with its projector (the memory fold is left
    out), counted by ``flop_counter`` over the plain reference."""
    from perfbench import flops

    params = weights.policy_params(seed, rcfg, dev)
    del params["llava"]["phi3"]
    n, s = rcfg.clip.image_size, rcfg.segmenter.imgsz
    pixels = ref.clip_pixels(torch.zeros(1, n, n, 3, dtype=torch.uint8, device=dev), n)
    total = flops.counted_flops(ref.clip_grid, params["clip"], rcfg.clip, pixels)
    total += flops.counted_flops(ref.llava_features, params["llava"], rcfg, pixels)
    if rcfg.segmenter.provider == "yolov8":
        total += flops.counted_flops(ref.yolo_forward, params["yolo"],
                                     torch.zeros(1, 3, s, s, device=dev))
    del params
    return total


def prompt_ids(tok, n_mm: int, log, ep_log, k: int, row: int):
    """The prompt ids of row ``row`` at window step ``k``: the cell's
    instruction and the history the episode's served ids give."""
    ep = next(e for e in ep_log if e["first"] <= k < e["last"])
    feed_i = log[k]["feeds"][row]
    gens = [log[j]["gens"][log[j]["feeds"].index(feed_i)] for j in range(ep["first"], k + 1)]
    return tok.encode(build_prompt(ep["episodes"][feed_i].instruction,
                                   histories(tok, gens)[-1], n_mm))


def _requests(rcfg, params, samples, log, ep_log):
    """Per sampled row: the reference's perception, its prompt ids and the
    request for Phi-3, beside what the program produced."""
    tok = ByteTokenizer(rcfg.llava.phi3.vocab_size)
    p3 = rcfg.llava.phi3
    out = []
    for s in samples:
        k = s["call"]
        with torch.no_grad():
            ro = ref.perceive(params, rcfg, s["pre"], *s["inputs"])
        n_mm = ro.mm_tokens.shape[1]
        for row in range(len(log[k]["feeds"])):
            ids = prompt_ids(tok, n_mm, log, ep_log, k, row)
            tv = s["tvalid"][row]
            prog_ids = s["ids"][row][tv].tolist()
            ids_off = sum(a != b for a, b in zip(ids, prog_ids)) + abs(len(ids) - len(prog_ids))
            ids_t = torch.tensor(ids, device=s["gen"].device)
            splice = ids.index(tok.image_id)
            emb = params["llava"]["phi3"]["embed_tokens"][ids_t].float()
            mm = ro.mm_tokens[row].float()
            emb[splice: splice + n_mm] = mm
            keep = torch.ones(len(ids), dtype=torch.bool, device=emb.device)
            keep[splice: splice + n_mm] = ro.mm_valid[row]
            served = s["gen"][row][: served_len(s["gen"][row].tolist(), p3.end_token_id)]
            out.append({"sample": s, "row": row, "ref_out": ro, "ids_off": ids_off,
                        "request": phi3_ref.Request(emb[keep], served)})
    return out


def _start_off(rcfg, samples, ep_log) -> int:
    """Entries of the program's memory before an episode's first step that
    differ from the reference's empty table."""
    off = 0
    for s in samples:
        if any(e["first"] == s["call"] for e in ep_log):
            pre = s["pre"]
            init = ref.empty_state(rcfg.fields, pre.patch_pos.shape[0], pre.patch_pos.device)
            off += sum(int((getattr(pre, k) != v).sum()) for k, v in init._asdict().items())
    return off


def _perception_off(rs, row_tol: float, ro_key="ref_out") -> Dict[str, float]:
    """The shares of memory rows and of multimodal token rows off by more
    than ``row_tol``, and by more than each of ``TOLS``."""
    mem, mm = [], []
    for r in rs:
        s, row, ro = r["sample"], r["row"], r[ro_key]
        mem.append(_memory_errors(_row(s["post"], row), _row(ro.state, row)))
        mm.append(_row_errors(s["mm"][row], ro.mm_tokens[row], s["mm_valid"][row],
                              ro.mm_valid[row]))
    mem, mm = torch.cat(mem), torch.cat(mm)

    def share(e, tol):
        return float((e > tol).sum()) / max(e.numel(), 1)

    return {"memory_rows_off": share(mem, row_tol), "mm_rows_off": share(mm, row_tol),
            "memory_rows_off_at": [share(mem, t) for t in TOLS],
            "mm_rows_off_at": [share(mm, t) for t in TOLS]}


def readings(ctx, rcfg, samples, log, ep_log, control: bool = False) -> Dict[str, float]:
    """The compared numbers; ``control`` reads the lower-precision
    reference in the program's place instead of the program."""
    dev = ctx.device
    row_tol = float(ctx.cell["check"]["row_tol"])
    params = weights.policy_params(ctx.seed, rcfg, dev)
    rs = _requests(rcfg, params, samples, log, ep_log)
    p3 = rcfg.llava.phi3
    reqs = [r["request"] for r in rs]
    with torch.no_grad():
        ref_logits = phi3_ref.served_logits(params["llava"]["phi3"], p3, reqs)
    out: Dict[str, float] = {}
    if not control:
        out.update(_perception_off(rs, row_tol))
        out["start_state_off"] = float(_start_off(rcfg, samples, ep_log))
        gap = max((float(phi3_ref.gaps(lg, r.served).max()) for lg, r in zip(ref_logits, reqs)),
                  default=float("nan"))
        out.update(prompt_ids_off=float(sum(r["ids_off"] for r in rs)), logit_gap=gap,
                   served_tokens=float(sum(int(r.served.numel()) for r in reqs)))
        return out
    ctl = control_params(params)
    with torch.no_grad():
        for r in rs:
            s = r["sample"]
            if "ctl_out" not in s:
                s["ctl_out"] = ref.perceive(ctl, rcfg, s["pre"], *s["inputs"])
            r["ctl_out"] = s["ctl_out"]
        # the reference in the sample's place: the control against it
        for r in rs:
            r["sample"] = dict(r["sample"], post=r["ref_out"].state, mm=r["ref_out"].mm_tokens,
                               mm_valid=r["ref_out"].mm_valid)
        out.update(_perception_off(rs, row_tol, "ctl_out"))
        ctl_logits = phi3_ref.served_logits(params["llava"]["phi3"], p3, reqs, phi3_ref.CONTROL)
    gap = max(float(phi3_ref.gaps(lg, c.argmax(-1)).max()) for lg, c in zip(ref_logits, ctl_logits))
    out["logit_gap"] = gap
    return out


def judge(limits: Dict, got: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number that ``got`` holds beside its limit (the cell
    file's ``limits``): the program's readings, or the control's."""
    out = {n: {"value": got[n], "limit": limits[n], "ok": bool(got[n] <= limits[n])}
           for n in COMPARED if n in got}
    if "served_tokens" in got:
        out["served_tokens"] = {"value": got["served_tokens"], "limit": limits["served_tokens"],
                                "ok": bool(got["served_tokens"] >= limits["served_tokens"])}
    return out

