"""Faults planted under the timed path, for the tests that show the check
catches them (never in a benchmark run): a step that returns its state
unchanged, half of the batch left out (its rows copied from the other
half), and a token altered where it is produced."""

from __future__ import annotations

import torch

NAMES = ("state_unchanged", "half_batch", "token_altered")


def perceive(fault: str, state, out):
    if fault == "state_unchanged":
        return out._replace(state=state)
    if fault == "half_batch" and out.mm_tokens.shape[0] > 1:
        B = out.mm_tokens.shape[0]
        src = torch.arange(B, device=out.mm_tokens.device) % ((B + 1) // 2)
        return out._replace(state=type(out.state)(*(t[src] for t in out.state)),
                            mm_tokens=out.mm_tokens[src], mm_valid=out.mm_valid[src])
    return out


def generate(fault: str, gen: torch.Tensor, vocab: int) -> torch.Tensor:
    if fault == "token_altered":
        gen = gen.clone()
        gen[..., 1] = (gen[..., 1] + 1) % vocab
    return gen
