"""Closed-loop VLN episodes: ``EpisodeRunner.run`` over B synthetic-room
feeds, back to back, for the window (the evaluation cells).

Set-up makes the policy's weights from the seed on the card, quantizes
Phi-3 as the configuration says (``quantize_phi3``), and runs two short
episodes at the cell's batch, with the fewest and the most instruction
words, so every shape the traffic uses has run once.  The window then runs
the traffic's episodes until ``--seconds`` have passed: each feed reports
its episode done at the first step that ends past the deadline.

Two program functions are wrapped for the window (as module attributes,
which ``policy.full_step`` looks up at each call): ``policy.perceive`` and
``policy.generate_action_ids``.  The wrappers open the benchmark's spans
``perceive`` and ``generate``, start and stop the traced sub-window by step
count, and, at steps drawn from the seed, keep copies on the card of what
the check needs: the memory state before and after the step, the step's
inputs, the multimodal tokens, the prompt ids and the served ids.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check_vln, faults, flops, traffic, weights
from perfbench.harness import since_start
from perfbench.reference import config as ref_config
from perfbench.trace import Traced, span, span_seconds


class WindowFeed:
    """A synthetic-room feed that ends its episode once the window closes."""

    def __init__(self, feed, deadline: List[float]):
        self.feed, self.deadline = feed, deadline

    def reset(self):
        with span("feed"):
            return self.feed.reset()

    def step(self, action):
        with span("feed"):
            o, d, info = self.feed.step(action)
        if time.perf_counter() >= self.deadline[0]:
            d = True
        return o, d, info

    def oracle_distance(self, *a):
        return self.feed.oracle_distance(*a)


class Wrappers:
    """The window's wrappers of ``perceive`` and ``generate_action_ids``."""

    def __init__(self, policy_mod, sample_at: set, trace_at: Optional[range], counter: Dict,
                 fault: Optional[str] = None):
        self.mod, self.counter, self.fault = policy_mod, counter, fault
        self.perceive0, self.generate0 = policy_mod.perceive, policy_mod.generate_action_ids
        self.sample_at, self.trace_at = sample_at, trace_at
        self.calls = 0
        self.cur: Optional[Dict] = None
        self.samples: List[Dict] = []
        self.traced: Optional[Traced] = None
        self.trace_done: Optional[Traced] = None
        self.trace_steps: List[int] = []
        self.trace_launches: Dict[str, int] = {}

    def install(self):
        self.mod.perceive, self.mod.generate_action_ids = self.perceive, self.generate

    def remove(self):
        self.mod.perceive, self.mod.generate_action_ids = self.perceive0, self.generate0
        if self.traced is not None:
            self._stop_trace()

    def _stop_trace(self):
        self.traced.__exit__(None, None, None)
        self.trace_done, self.traced = self.traced, None
        self.trace_launches = {n: v - self.trace_launches.get(n, 0)
                               for n, v in self.counter.items()}

    def _trace_tick(self, k: int):
        if self.trace_at is None:
            return
        if k == self.trace_at.start:
            self.trace_launches = dict(self.counter)
            self.traced = Traced().__enter__()
        elif k == self.trace_at.stop and self.traced is not None:
            self._stop_trace()
        if self.traced is not None:
            self.trace_steps.append(k)

    def perceive(self, params, cfg, state, rgb, depth, pos, hd, delete_old=True):
        k = self.calls
        self.calls += 1
        self._trace_tick(k)
        take = k in self.sample_at
        if take:
            self.cur = {"call": k, "pre": type(state)(*(t.clone() for t in state)),
                        "inputs": (rgb.clone(), depth.clone(), pos.clone(), hd.clone())}
        with span("perceive"):
            out = self.perceive0(params, cfg, state, rgb, depth, pos, hd, delete_old)
        if self.fault:
            out = faults.perceive(self.fault, state, out)
        if take:
            self.cur.update(mm=out.mm_tokens.clone(), mm_valid=out.mm_valid.clone(),
                            post=type(out.state)(*(t.clone() for t in out.state)))
        return out

    def generate(self, params, cfg, input_ids, text_valid, mm_tokens, mm_valid,
                 splice_start=2, prev_gen=None, stats=None):
        with span("generate"):
            gen = self.generate0(params, cfg, input_ids, text_valid, mm_tokens, mm_valid,
                                 splice_start, prev_gen=prev_gen, stats=stats)
        if self.fault:
            gen = faults.generate(self.fault, gen, cfg.llava.phi3.vocab_size)
        if self.cur is not None:
            self.cur.update(ids=input_ids.clone(), tvalid=text_valid.clone(),
                            gen=gen.reshape(input_ids.shape[0], -1).clone())
            self.samples.append(self.cur)
            self.cur = None
        return gen


def _feeds(eps, tr: Dict, rgb_size: int, deadline: List[float]):
    from dynam3d_torch.runtime.feed import SyntheticRoomFeed

    return [WindowFeed(SyntheticRoomFeed(rgb_size=rgb_size, depth_size=int(tr["depth_size"]),
                                         views=int(tr["views"]), room=e.room, goal=e.goal,
                                         start=e.start, instruction=e.instruction,
                                         seed=e.feed_seed), deadline)
            for e in eps]


def _sample_steps(tr: Dict, seed: int, upto: int, n: int) -> set:
    """The window steps the check samples: ``n`` of the first ``upto``,
    drawn from the seed, among them the window's first step (its memory is
    the empty table the check holds against the reference's) and the last
    step of the first episode with the most instruction words (its prompt
    is the longest: the longest instruction after a full history)."""
    B = int(tr["batch"])
    at, last, most = 0, None, -1
    eps = traffic.episodes(tr, seed)
    while at < upto:
        batch = [next(eps) for _ in range(B)]
        steps = max(e.steps for e in batch)
        words = max(len(e.instruction.split()) for e in batch)
        if words > most and at + steps - 1 < upto:
            last, most = at + steps - 1, words
        at += steps
    r = traffic.rng(seed, 11)
    pick = [int(i) for i in r.choice(upto, size=n, replace=False)]
    if last is not None and last not in pick:
        pick[-1] = last
    if 0 not in pick:
        pick[0] = 0
    return set(pick)


def run(ctx) -> Dict:
    from dynam3d_torch.config import from_dict
    from dynam3d_torch.models import policy as policy_mod
    from dynam3d_torch.models.vlm.phi3 import quantize_phi3
    from dynam3d_torch.ops import kernels
    from dynam3d_torch.runtime.episode import EpisodeRunner

    dev = ctx.device
    model = ctx.config["model"]
    cfg = from_dict(model)
    rcfg = ref_config.from_dict(model)
    tr = ctx.cell["traffic"]
    B = int(tr["batch"])
    rgb = cfg.clip.image_size

    # --- set-up: weights from the seed, the served quantization, warm shapes
    params = weights.policy_params(ctx.seed, rcfg, dev)
    bits = int(ctx.config["precision"]["phi3_weight_bits"])
    if bits:
        params["llava"]["phi3"] = quantize_phi3(params["llava"]["phi3"], bits=bits, consume=True)
    runner = EpisodeRunner(params, cfg, views=int(tr["views"]), device=dev)
    never = [float("inf")]
    for e in traffic.warm_episodes(tr):
        runner.run(_feeds([e] * B, tr, rgb, never), max_steps=e.steps, ignore_stop=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runner.step_log.clear()

    # --- the window
    chk = ctx.cell["check"]
    sample_at = _sample_steps(tr, ctx.seed, int(chk["sample_range"]), int(chk["sample_steps"]))
    trace_at = None
    if ctx.trace and dev.type == "cuda":
        t0_, n_ = int(ctx.cell["window"]["trace_start"]), int(ctx.cell["window"]["trace_steps"])
        trace_at = range(t0_, t0_ + n_)
    wraps = Wrappers(policy_mod, sample_at, trace_at, kernels.launches, ctx.fault)
    episodes = traffic.episodes(tr, ctx.seed)
    ep_log: List[Dict] = []
    setup_s = since_start()
    t_start = time.perf_counter()
    deadline = [t_start + ctx.seconds]
    wraps.install()
    try:
        while time.perf_counter() < deadline[0]:
            eps = [next(episodes) for _ in range(B)]
            steps = max(e.steps for e in eps)
            n0 = len(runner.step_log)
            with span("episode"):
                runner.run(_feeds(eps, tr, rgb, deadline), max_steps=steps, ignore_stop=True)
            ep_log.append({"episodes": eps, "first": n0, "last": len(runner.step_log)})
    finally:
        wraps.remove()
    t_end = time.perf_counter()
    window_s = t_end - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    log = runner.step_log
    ms = [s["ms"] for s in log]
    notes = {"step_ms_q": [float(np.percentile(ms, q)) for q in (0, 10, 50, 90, 100)] if ms
             else [], "steps": len(ms), "span_s": span_seconds(t_start, t_end),
             "card_after": flops.card_state() if dev.type == "cuda" else "cpu"}
    rows = [len(s["feeds"]) for s in log]
    failed = sum(1 for s in log if s.get("mm_finite") is False)
    e2e = {"setup_s": setup_s,
           "step_ms": 1e3 * window_s / max(len(log), 1),
           "step_p90_ms": float(np.percentile(ms, 90)) if ms else float("nan"),
           "agent_steps_per_s": sum(rows) / window_s}

    # what the per-layer readers read
    p3 = cfg.llava.phi3
    steps = [{"passes": s.get("passes"), "tokens": s.get("tokens"),
              "served": [check_vln.served_len(list(g), p3.end_token_id) for g in s["gens"]]}
             for s in log]
    layer = {"steps": steps, "phi3": p3, "trace_steps": wraps.trace_steps,
             "trace_launches": wraps.trace_launches,
             "trace": wraps.trace_done.summarize() if wraps.trace_done else None}

    # --- the check, after the window, on the program's state freed
    samples, n_mm = wraps.samples, runner.n_mm
    del runner, params, wraps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.trace:
        # each traced row's valid prompt tokens, at least: its ids less the
        # instance and zone slots, which may be masked
        from dynam3d_torch.models.policy import I_ENV, Z_ENV
        from perfbench.reference.tokenizer import ByteTokenizer

        tok = ByteTokenizer(p3.vocab_size)
        layer["trace_rows"] = [
            [len(check_vln.prompt_ids(tok, n_mm, log, ep_log, k, row)) - I_ENV - Z_ENV
             for row in range(len(log[k]["feeds"]))] for k in layer["trace_steps"]]
        layer["views"] = int(tr["views"])
        layer["perceive_flops_per_view"] = check_vln.perception_flops(ctx.seed, rcfg, dev)
        gc.collect()
    got = check_vln.readings(ctx, rcfg, samples, log, ep_log)
    checks = check_vln.judge(ctx.cell["check"]["limits"], got)
    notes["row_shares_at"] = {"tols": check_vln.TOLS, "memory": got["memory_rows_off_at"],
                              "mm": got["mm_rows_off_at"]}
    extra = {}
    if ctx.control:
        extra["control"] = check_vln.readings(ctx, rcfg, samples, log, ep_log, control=True)
    return {**extra, "notes": notes, "readings": got, "e2e": e2e, "layer": layer, "checks": checks,
            "attempted": sum(rows), "failed": failed, "memory_peak_bytes": memory_peak,
            "trace": layer["trace"]}
