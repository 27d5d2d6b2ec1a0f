"""A/B of speculative decode at B = 1: the verify pass's cost against a
plain decode pass, and greedy_decode_spec against plain greedy_decode, on
Phi-3-mini with int4 weights.

    python -m dynam3d_torch.tools.ab_spec_decode [--prompt 816] [--tokens 120,20]

Port of ``tools/ab_spec_decode.py``; ``DYNAM3D_AB_PROMPT`` is ``--prompt``.

1. The ring pass as ``greedy_decode_spec`` runs it (``_ring_pass``: k
   rows sharing one weight stream, kernel B in shared-cache mode and four
   kernel A a layer, replayed from its CUDA graph) at k = 1 (the plain
   pass), 4 and 8 (verify passes), each the mean device ms of a pass after
   an L2 read flush, from the cache of one prefill.  Decode streams the
   weights, so a pass should cost about the same at any k.
2. ``greedy_decode`` (plain) and ``greedy_decode_spec`` with a planted
   continuation (its own no-lookup output placed in the lookup: every
   draft the model's own greedy continuation, full acceptance), under
   ``flags.spec_force_accept`` (every draft accepted, the same compute),
   and with no lookup (every pass without a draft runs one plain step), at
   each ``--tokens`` length with no stop token: p50 host ms of synchronized
   calls, ms per token from the slope, passes per call.

Checks: the planted ids equal plain greedy's (a difference only where the
plain pass's top-2 margin is under ``tol`` x its logits' scale, a
near-tie); force-accept with the planted continuation emits the drafts
(the continuation; a difference only where the forced pass's own margin
at that row is a near-tie) in ceil((n - 1) / k) passes; force-accept
with no lookup also takes ceil((n - 1) / k) passes.  One
JSON line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Sequence

import numpy as np
import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def verify_costs(params, cfg, dev, embeds, valid, ks=(1, 4, 8), iters: int = 20) -> Dict:
    """Device ms of one ring pass of k rows as ``greedy_decode_spec`` runs
    it (``phi3._ring_pass``: replayed from its CUDA graph on the card)."""
    from dynam3d_torch.models.vlm import phi3

    T = embeds.shape[1]
    total = -(-(T + 64) // phi3.ROWS) * phi3.ROWS
    pos0, wslot = int(valid.sum()), T
    flush = card.read_flush() if dev.type == "cuda" else None
    out = {}
    with phi3._ring_lock:
        buf = phi3._buffers(cfg, total, embeds.dtype, dev)
        if dev.type == "cuda":
            phi3._claim_graphs(params, cfg, embeds.dtype)
        phi3._prefill(params, cfg, embeds, valid, total, cache=buf.cache)
        buf.valid.zero_()
        buf.valid[:, :T] = valid
        for k in ks:
            ids = np.arange(k)
            out[f"verify_k{k}"] = card.kernel_ms(lambda ids=ids: phi3._ring_pass(
                params, cfg, buf, ids, pos0, wslot), dev, flush, iters)
    return out


def _draft_len(n: int) -> int:
    from dynam3d_torch import flags

    return max(2, min(int(flags.SPEC_DRAFT_LEN), n, 8))


def run(params, cfg, dev, tokens: Sequence[int] = (120, 20), prompt: int = 816, reps: int = 3,
        tol: float = 0.05) -> Dict:
    from dynam3d_torch.models.vlm import phi3

    line = card.card_line(dev)
    holes = [(700, 708)] if prompt > 708 else []
    embeds, valid = card.prompt(cfg, dev, 1, prompt, holes=holes)
    out = {"verify": card.emit(dict(tool="ab_spec_decode", part="verify_pass_ms",
                                    **verify_costs(params, cfg, dev, embeds, valid)), line)}

    def spec(n, lookup=None, stats=None):
        return phi3.greedy_decode_spec(params, cfg, embeds, valid, n, stop_token=-1,
                                       lookup_ids=lookup, stats=stats)

    hi, lo = max(tokens), min(tokens)
    runs = {}
    for n in tokens:
        k = _draft_len(n)
        with card.margins() as plain_passes:
            plain = phi3.greedy_decode(params, cfg, embeds, valid, n, stop_token=-1)[0].tolist()
        ref = spec(n)[0].tolist()                      # the continuation to plant
        lookup = torch.as_tensor([-1] * 4 + ref + [-1] * 12, device=dev)
        st = {name: {} for name in ("planted", "nolookup", "forced", "forced_nolookup")}
        ids = {"plain": plain, "planted": spec(n, lookup, st["planted"])[0].tolist(),
               "nolookup": spec(n, None, st["nolookup"])[0].tolist()}
        with card.env(DYNAM3D_SPEC_FORCE_ACCEPT="1"):
            with card.margins() as forced_passes:
                ids["forced"] = spec(n, lookup, st["forced"])[0].tolist()
            ids["forced_nolookup"] = spec(n, None, st["forced_nolookup"])[0].tolist()
            ms_forced = card.step_ms(lambda: spec(n), dev, reps)
        ms = {"plain": card.step_ms(lambda: phi3.greedy_decode(
                  params, cfg, embeds, valid, n, stop_token=-1), dev, reps),
              "planted": card.step_ms(lambda: spec(n, lookup), dev, reps),
              "nolookup": card.step_ms(lambda: spec(n), dev, reps), "forced": ms_forced}
        want_passes = math.ceil((n - 1) / k)
        checks = {
            "planted_vs_plain": card.ids_agree(ids["planted"], plain, plain_passes, 0, tol),
            # id i > 0 comes from verify pass (i - 1) // k, row (i - 1) % k
            "forced_emits_drafts": card.ids_agree(
                ids["forced"], ref, forced_passes, 0, tol,
                at=lambda i: (0, -1) if i == 0 else (1 + (i - 1) // k, (i - 1) % k)),
            "forced_passes": st["forced"]["passes"] == want_passes,
            "forced_nolookup_all_accepted": st["forced_nolookup"]["passes"] == want_passes,
        }
        runs[n] = card.emit({
            "tool": "ab_spec_decode", "tokens": n, "draft_len": k, "ms": ms,
            "passes": {name: s.get("passes") for name, s in st.items()},
            "nolookup_vs_plain": card.first_difference(ids["nolookup"], plain),
            "checks": checks,
            "ok": checks["planted_vs_plain"]["ok"] and checks["forced_emits_drafts"]["ok"]
            and checks["forced_passes"] and checks["forced_nolookup_all_accepted"]}, line)
    out["runs"] = runs
    out["ms_per_token"] = card.emit({
        "tool": "ab_spec_decode", "part": "ms_per_token",
        **{name: card.slope(runs[hi]["ms"][name], runs[lo]["ms"][name], hi, lo)
           for name in runs[hi]["ms"]}}, line)
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompt", type=int, default=816)
    p.add_argument("--tokens", default="120,20")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    cfg, params = card.int4_phi3(args.seed, dev)
    return run(params, cfg, dev, [int(t) for t in args.tokens.split(",")], args.prompt,
               args.reps)


if __name__ == "__main__":
    main()
