"""A/B of batched speculative decode (``greedy_decode_spec`` at B >= 2) on
Phi-3-mini with int4 weights: B episodes each verify g = 8 // B drafts a
pass, B x g ring rows sharing one weight stream.

    python -m dynam3d_torch.tools.ab_spec_batched [--batches 2,4]
        [--tokens 120,20] [--prompt 816]

Port of ``tools/ab_spec_batched.py``; ``DYNAM3D_AB_PROMPT`` is
``--prompt``.  For each B, at each ``--tokens`` length with no stop token
(p50 host ms of synchronized calls; ms per token of an episode from the
slope, every row decoding in the same passes):

1. plain batched ``greedy_decode`` (B ring rows);
2. spec under ``flags.spec_force_accept`` (every pass advances g tokens
   in every row);
3. spec with no lookup (drafts only from the rows' own repeats);
4. the row-wise ids of (3) against (1): equal, or first differing where
   the plain pass's top-2 margin of that row is under ``tol`` x its
   logits' scale (a near-tie).

The rows' prompts differ in length (row b has 8 masked positions ending
9 b before the end).  One JSON line a (B, n) and one a B's slopes, each
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Sequence

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def run(params, cfg, dev, batches: Sequence[int] = (2, 4), tokens: Sequence[int] = (120, 20),
        prompt: int = 816, reps: int = 3, tol: float = 0.05) -> Dict:
    from dynam3d_torch.models.vlm import phi3

    line = card.card_line(dev)
    hi, lo = max(tokens), min(tokens)
    out = {}
    for B in batches:
        g = 8 // B
        holes = [(prompt - 9 * b - 8, prompt - 9 * b) for b in range(B)]
        embeds, valid = card.prompt(cfg, dev, B, prompt, holes=holes)

        def plain(n):
            return phi3.greedy_decode(params, cfg, embeds, valid, n, stop_token=-1)

        def spec(n, stats=None):
            return phi3.greedy_decode_spec(params, cfg, embeds, valid, n, stop_token=-1,
                                           stats=stats)

        runs = {}
        for n in tokens:
            with card.margins() as passes:
                ids_plain = plain(n).cpu().tolist()
            st_nl, st_f = {}, {}
            ids_nl = spec(n, st_nl).cpu().tolist()
            with card.env(DYNAM3D_SPEC_FORCE_ACCEPT="1"):
                spec(n, st_f)
                ms_forced = card.step_ms(lambda: spec(n), dev, reps)
            rows = [card.ids_agree(ids_nl[b], ids_plain[b], passes, b, tol) for b in range(B)]
            runs[n] = card.emit({
                "tool": "ab_spec_batched", "batch": B, "g": g, "tokens": n,
                "ms": {"plain": card.step_ms(lambda: plain(n), dev, reps),
                       "spec_forced": ms_forced,
                       "spec_nolookup": card.step_ms(lambda: spec(n), dev, reps)},
                "passes": {"spec_forced": st_f["passes"], "spec_nolookup": st_nl["passes"]},
                "nolookup_vs_plain": rows,
                "ok": all(r["ok"] for r in rows)
                and st_f["passes"] == math.ceil((n - 1) / max(2, min(g, n)))}, line)
        out[B] = {"runs": runs, "slopes": card.emit({
            "tool": "ab_spec_batched", "batch": B, "part": "ms_per_token_per_episode",
            **{k: card.slope(runs[hi]["ms"][k], runs[lo]["ms"][k], hi, lo)
               for k in runs[hi]["ms"]}}, line)}
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="2,4")
    p.add_argument("--tokens", default="120,20")
    p.add_argument("--prompt", type=int, default=816)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    cfg, params = card.int4_phi3(args.seed, dev)
    return run(params, cfg, dev, [int(b) for b in args.batches.split(",")],
               [int(t) for t in args.tokens.split(",")], args.prompt, args.reps)


if __name__ == "__main__":
    main()
