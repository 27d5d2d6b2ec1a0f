"""The B = 1 serving step split between the host and the card: N full steps
back to back, their per-step slope, the card's busy time over the same
steps and the idle share.

    python -m dynam3d_torch.tools.prof_full_step [--n1 4 --n2 10] [--reps 3]

Port of ``tools/prof_full_step.py``, on the default ``Dynam3DConfig()``
with int4 Phi-3-mini (speculative decode, the ring).  A chain of n steps
runs ``policy.full_step`` as ``EpisodeRunner`` wires it: the memory
threaded from step to step, a different pre-staged frame each step (the
feed walking its room, uploaded before the chain), each step's generation
priming the next step's drafts (``prev_gen``).  The per-step time is the
slope of the chains' synchronized host ms (p50 over ``--reps``) between
``--n2`` and ``--n1`` steps, which cancels what a chain pays once.  The
same two chains then run under ``runtime.profiling.trace``, recording the
card's kernels alone: the card's busy time a step is the slope of the
kernels' summed device time, and the idle share is one less busy over the
un-profiled step.  One JSON
line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from dynam3d_torch.device import resolve_device
from dynam3d_torch.tools import card


def device_busy_ms(prof) -> Optional[float]:
    """Summed device time of the kernels a profile saw (None if it saw
    none: then the device time is not measured)."""
    from torch.autograd import DeviceType

    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0)
    return us / 1e3 if us > 0 else None


def chain(params, cfg, dev, n2: int, seed: int = 0):
    """``run(n)``: n full steps from a fresh memory on the first n of ``n2``
    pre-staged frames; returns the last step's ids."""
    from dynam3d_torch.models import policy
    from dynam3d_torch.runtime.episode import EpisodeRunner
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    runner = EpisodeRunner(params, cfg, device=dev)
    feed = SyntheticRoomFeed(rgb_size=cfg.clip.image_size,
                             depth_size=256 if cfg.clip.image_size >= 224 else 32, views=1,
                             seed=seed)
    obs = feed.reset()
    frames = []
    for _ in range(n2):
        rgb, depth, pos = runner._upload(obs)
        frames.append((rgb[None], depth[None], pos[None],
                       torch.tensor([obs.heading], dtype=torch.float32, device=dev)))
        obs, _, _ = feed.step((0.1, 0.25))
    ids, tv, _ = runner._prompt_ids([obs.instruction], [["none\n"] * 4])

    def run(n: int):
        st, gen = policy.batched_init_state(cfg, 1, dev), None
        for rgb, depth, pos, hd in frames[:n]:
            st, gen = runner._full_step(st, rgb, depth, pos, hd, ids, tv, prev_gen=gen)
        return gen

    return run


def run(params, cfg, dev, n1: int = 4, n2: int = 10, reps: int = 3) -> Dict:
    from dynam3d_torch.runtime.profiling import trace

    line = card.card_line(dev)
    steps = chain(params, cfg, dev, n2)
    t1, t2 = (card.step_ms(lambda n=n: steps(n), dev, reps) for n in (n1, n2))
    step = card.slope(t2, t1, n2, n1)
    busy = {}
    if dev.type == "cuda":
        for n in (n1, n2):
            with trace(None, activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                steps(n)
                card.sync(dev)
            busy[n] = device_busy_ms(prof)
    busy_step = card.slope(busy.get(n2), busy.get(n1), n2, n1)
    return card.emit({
        "tool": "prof_full_step", "n1": n1, "n2": n2, "reps": reps,
        "chain_ms": {str(n1): t1, str(n2): t2}, "step_ms": step,
        "device_busy_ms": {str(n): b for n, b in busy.items()}, "device_busy_step_ms": busy_step,
        "host_step_ms": None if step is None or busy_step is None else step - busy_step,
        "idle_share": None if step is None or busy_step is None
        else max(0.0, 1.0 - busy_step / step)}, line)


def main(argv=None, device=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n1", type=int, default=4)
    p.add_argument("--n2", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cpu, or the card when omitted")
    args = p.parse_args(argv)
    dev = resolve_device(args.device or device)
    from dynam3d_torch.config import Dynam3DConfig
    from dynam3d_torch.models import policy
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3

    cfg = Dynam3DConfig()
    params = policy.init_policy_params(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                                       device=dev)
    params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=4, consume=True)
    return run(params, cfg, dev, args.n1, args.n2, args.reps)


if __name__ == "__main__":
    main()
