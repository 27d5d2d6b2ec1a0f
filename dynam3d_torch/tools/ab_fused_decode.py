"""A/B of the fused decode routes against the unfused one: greedy decode of
Phi-3-mini on int4 weights, ms per token on each route, and the routes'
one-step logits and ids side by side.

    python -m dynam3d_torch.tools.ab_fused_decode [--batch 1] [--tokens 20,5]
        [--prompt 816] [--only ring,split] [--no-control]

Port of ``tools/ab_fused_decode.py``; its environment knobs are flags.  The
routes (``card.ROUTES``, chosen by the decode gates): ``ring`` (a layer a
pass as kernel B and four kernel A), ``split`` (kernels H and G; B = 1
only) and ``unfused`` (kernel A for the projections, F for the MLP,
PyTorch attention).  ``--only`` keeps the named routes and, unless
``--no-control``, the unfused one.  Each route decodes ``--tokens`` chain
lengths with no stop token; the ms per token is the slope between the
longest and shortest (p50 host ms of synchronized calls), which cancels the
prefill.  Then, with the logits of every pass recorded: the first decode
pass's logits of each fused route against the unfused one (max abs
difference within ``logits_tol`` of their scale, argmax), and its ids
against the unfused ids, a difference allowed only where the unfused
pass's top-2 margin is under ``tol`` of its scale (a near-tie).  The
batch's rows have prompts of different lengths (row 0 has a masked span).
One JSON line a route, then one a parity, each with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def _holes(batch: int, T: int):
    """Row 0: a masked span (the mask path) when the prompt is long enough;
    row b > 0: its last 60 b positions masked (another prompt length)."""
    holes = [(700, 708) if T > 708 else (0, 0)]
    return holes + [(T - 60 * b, T) for b in range(1, batch)]


def run(params, cfg, dev, batch: int = 1, tokens: Sequence[int] = (20, 5), prompt: int = 816,
        only: Sequence[str] = (), control: bool = True, reps: int = 3,
        tol: float = 0.05, logits_tol: float = 0.10) -> Dict:
    """Every route's slope and the parity records; ``tol``: the near-tie
    margin, ``logits_tol``: the one-step logits tolerance, each relative to
    the logits' scale."""
    from dynam3d_torch.models.vlm import phi3

    if len(set(tokens)) < 2:
        raise ValueError("--tokens needs two distinct chain lengths")
    line = card.card_line(dev)
    routes = ["unfused", "split", "ring"]
    if only:
        keep = set(only) | ({"unfused"} if control else set())
        routes = [r for r in routes if r in keep]
    if batch > 1 and "split" in routes:
        routes.remove("split")        # the split route is B = 1 only
    embeds, valid = card.prompt(cfg, dev, batch, prompt, holes=_holes(batch, prompt))
    hi, lo = max(tokens), min(tokens)
    out = {"routes": {}, "parity": {}}
    ids, passes = {}, {}
    for name in routes:
        with card.env(**card.ROUTES[name]):
            per = {n: card.step_ms(lambda n=n: phi3.greedy_decode(
                params, cfg, embeds, valid, n, stop_token=-1), dev, reps) for n in tokens}
            with card.margins() as seen:
                got = phi3.greedy_decode(params, cfg, embeds, valid, hi, stop_token=-1)
        ids[name], passes[name] = got.cpu().tolist(), seen
        out["routes"][name] = card.emit({
            "tool": "ab_fused_decode", "route": name, "batch": batch, "prompt": prompt,
            "ms": {str(n): per[n] for n in tokens},
            "ms_per_token": card.slope(per[hi], per[lo], hi, lo)}, line)
    if "unfused" in ids:
        for name in ids:
            if name == "unfused":
                continue
            lf, lu = passes[name][1]["logits"], passes["unfused"][1]["logits"]
            scale = float(lu.abs().max())
            rows = [card.ids_agree(ids[name][b], ids["unfused"][b], passes["unfused"], b, tol)
                    for b in range(batch)]
            max_abs = float((lf - lu).abs().max())
            out["parity"][name] = card.emit({
                "tool": "ab_fused_decode", "parity": f"{name}_vs_unfused", "batch": batch,
                "logits_max_abs": max_abs, "scale": scale, "tolerance": logits_tol * scale,
                "argmax_same": (lf.argmax(-1) == lu.argmax(-1)).tolist(), "ids": rows,
                "ok": max_abs <= logits_tol * scale and all(r["ok"] for r in rows)}, line)
    return out


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--tokens", default="20,5")
    p.add_argument("--prompt", type=int, default=816)
    p.add_argument("--only", default="", help="routes to keep: ring, split, unfused")
    p.add_argument("--no-control", action="store_true",
                   help="with --only, drop the unfused control")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    cfg, params = card.int4_phi3(args.seed, dev)
    return run(params, cfg, dev, args.batch, [int(t) for t in args.tokens.split(",")],
               args.prompt, [r for r in args.only.split(",") if r], not args.no_control,
               args.reps)


if __name__ == "__main__":
    main()
