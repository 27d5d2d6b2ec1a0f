"""Closed-loop episode runner: host feed <-> device policy step; port of
``runtime/episode.py::EpisodeRunner`` (``run`` over a batch of feeds,
``pre_explore``, ``run_interleaved``, ``pack_depth``, ``_prompt_ids`` with
128-token buckets, ``prev_gen`` priming).

The host owns tokenization, action parsing, history strings and the feed;
the device owns perception, the 3D memory and the VLM.  The reference's
quirks are kept: NaN depth packs to 0, unparseable text is a zero action
that ends the episode, and STOP / zero actions are replaced by a small move
when ``ignore_stop`` is set.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.models import policy as policy_mod
from dynam3d_torch.models.policy import I_ENV, Z_ENV
from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer, build_prompt
from dynam3d_torch.runtime import profiling
from dynam3d_torch.runtime.feed import STOP, Feed
from dynam3d_torch.utils.actions import EpisodeActionState, parse_action


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class EpisodeRunner:
    """Runs a batch of VLN episodes closed-loop on ``device`` (the card
    unless ``device="cpu"``; ``params`` must live there).

    ``step_log`` records, per step, the generated ids of row 0, its text,
    the ids and texts of every live row with their feed indices, the prompt
    length, the speculative-decode tokens and passes and the step's wall
    time (synchronized).  With recording on (``runtime/profiling.py``) each
    step is a span ``step`` over the interval of its ``ms``, tagged with its
    index in ``step_log``, and each row's ``feeds[i].step`` a span
    ``step.feed``."""

    def __init__(self, params, cfg: Dynam3DConfig, tokenizer=None, views: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer(cfg.llava.phi3.vocab_size)
        self.views = views
        self.n_mm = views * cfg.fields.input_height * cfg.fields.input_width + I_ENV + Z_ENV
        probe = self.tok.encode(build_prompt("x", ["none\n"] * 4, 1))
        self.splice_start = probe.index(self.tok.image_id)
        self.step_log: List[Dict] = []

    def _full_step(self, st, rgb, d, pos, hd, ids, tv, prev_gen=None, stats=None):
        if prev_gen is None:
            prev_gen = torch.full((ids.shape[0], self.cfg.llava.max_new_tokens), -1,
                                  dtype=torch.int64, device=self.device)
        return policy_mod.full_step(self.params, self.cfg, st, rgb, d, pos, hd, ids, tv,
                                    self.splice_start, prev_gen=prev_gen, stats=stats)

    @staticmethod
    def pack_depth(depth: np.ndarray) -> np.ndarray:
        """Normalized [0, 1] depth -> the uint16 wire format (1/65535 steps),
        dequantized at the top of ``policy.perceive``."""
        return np.clip(np.round(np.asarray(depth, np.float32) * 65535.0), 0.0,
                       65535.0).astype(np.uint16)

    def _upload(self, o) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(o.rgb)).to(dev),
                torch.from_numpy(self.pack_depth(o.depth)).to(dev),
                torch.from_numpy(np.asarray(o.position, np.float32)).to(dev))

    def _prompt_ids(self, instructions: Sequence[str], histories: Sequence[List[str]],
                    gt_texts: Optional[Sequence[str]] = None):
        """Tokenize prompts to ``[B, T]`` with T rounded up to the prefill
        bucket; the ``<image>`` span sits at ``splice_start``."""
        rows = [self.tok.encode(build_prompt(ins, hist, self.n_mm,
                                             gt_texts[b] if gt_texts else ""))
                for b, (ins, hist) in enumerate(zip(instructions, histories))]
        T = _round_up(max(len(r) for r in rows), self.cfg.llava.prefill_bucket)
        B = len(rows)
        ids = np.full((B, T), self.tok.pad_id, np.int64)
        valid = np.zeros((B, T), bool)
        lens = np.zeros((B,), np.int64)
        for b, r in enumerate(rows):
            ids[b, : len(r)] = r
            valid[b, : len(r)] = True
            lens[b] = len(r)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(valid).to(self.device), lens)

    def pre_explore(self, feeds: Sequence[Feed], state, steps: int,
                    rng: Optional[np.random.Generator] = None):
        """Walk each feed ``steps`` random moves (a heading in [0, 2 pi), 0.25
        or 0.5 m) feeding every observation into the 3D memory, with no
        language-model step; the feeds are reset after, the memory is
        returned."""
        rng = rng or np.random.default_rng(0)
        obs = [f.reset() for f in feeds]
        dev = self.device
        for _ in range(steps):
            rgb = torch.from_numpy(np.stack([o.rgb for o in obs])).to(dev)
            depth = torch.from_numpy(np.stack([o.depth for o in obs])).to(dev)
            pos = torch.from_numpy(np.stack([o.position for o in obs])).to(dev)
            hd = torch.tensor([o.heading for o in obs], dtype=torch.float32, device=dev)
            state = policy_mod.perceive(self.params, self.cfg, state, rgb, depth, pos, hd).state
            for i, f in enumerate(feeds):
                obs[i], _, _ = f.step((float(rng.uniform(0, 2 * np.pi)),
                                       float(rng.choice([0.25, 0.5]))))
        for f in feeds:
            f.reset()
        return state

    def run(self, feeds: Sequence[Feed], max_steps: Optional[int] = None,
            pre_explore_steps: int = 0, ignore_stop: bool = False) -> List[Dict]:
        """Greedy closed-loop eval of one episode per feed (batched), after
        ``pre_explore_steps`` steps of :meth:`pre_explore`."""
        cfg = self.cfg
        max_steps = max_steps or cfg.train.max_traj_len
        B = len(feeds)
        state = policy_mod.batched_init_state(cfg, B, self.device)
        if pre_explore_steps:
            state = self.pre_explore(feeds, state, pre_explore_steps)
        obs = [f.reset() for f in feeds]
        act_state = [EpisodeActionState() for _ in range(B)]
        live = list(range(B))
        results: List[Optional[Dict]] = [None] * B
        dev_obs: Dict[int, Tuple] = {i: self._upload(obs[i]) for i in live}
        last_gen: Dict[int, torch.Tensor] = {}
        no_gen = torch.full((cfg.llava.max_new_tokens,), -1, dtype=torch.int64,
                            device=self.device)

        for stepk in range(max_steps):
            profiling.set_step(len(self.step_log))
            t0 = time.perf_counter()
            with profiling.span("step"):
                rgb = torch.stack([dev_obs[i][0] for i in live])
                depth = torch.stack([dev_obs[i][1] for i in live])
                pos = torch.stack([dev_obs[i][2] for i in live])
                hd = torch.tensor([obs[i].heading for i in live], dtype=torch.float32,
                                  device=self.device)
                ids, tvalid, lens = self._prompt_ids(
                    [obs[i].instruction for i in live],
                    [act_state[i].history_actions for i in live],
                )
                prev = torch.stack([last_gen.get(i, no_gen) for i in live])
                stats: Dict = {}
                state, gen = self._full_step(state, rgb, depth, pos, hd, ids, tvalid, prev,
                                             stats=stats)
                for row, i in enumerate(live):
                    last_gen[i] = gen[row]
                profiling.count("sync")
                gen_np = gen.cpu().numpy()

                done_now: List[int] = []
                texts = []
                for row, i in enumerate(list(live)):
                    text = self.tok.decode(gen_np[row])
                    cut = text.find("<|end|>")
                    if cut != -1:
                        text = text[:cut]
                    texts.append(text)
                    act_state[i].push_history(text + "\n")
                    action = parse_action(text, cfg.action)
                    if ignore_stop and stepk < max_steps - 1 and (
                        action == STOP or (action[0] == 0.0 and action[1] == 0.0)
                    ):
                        action = (0.1, 0.25)
                    if action == STOP or stepk == max_steps - 1 or (
                        action != STOP and action[0] == 0.0 and action[1] == 0.0
                    ):
                        with profiling.span("step.feed"):
                            o, d, info = feeds[i].step(STOP)
                        results[i] = {"steps": stepk + 1,
                                      "distance_to_goal": feeds[i].oracle_distance(), **info}
                        done_now.append(i)
                    else:
                        with profiling.span("step.feed"):
                            o, d, info = feeds[i].step(action)
                        obs[i] = o
                        if not d:
                            dev_obs[i] = self._upload(o)
                        if d:
                            results[i] = {"steps": stepk + 1,
                                          "distance_to_goal": feeds[i].oracle_distance(),
                                          **info}
                            done_now.append(i)
                if self.device.type == "cuda":
                    profiling.count("sync")
                    torch.cuda.synchronize(self.device)
                self.step_log.append({
                    "step": stepk, "gen": gen_np[0].tolist(), "text": texts[0],
                    "feeds": list(live), "gens": gen_np.tolist(), "texts": texts,
                    "prompt_tokens": int(lens[0]), "bucket": int(ids.shape[1]),
                    "passes": stats.get("passes"), "tokens": stats.get("tokens"),
                    "mm_finite": stats.get("mm_finite"),
                    "ms": (time.perf_counter() - t0) * 1e3,
                })

            for i in done_now:
                state = policy_mod.pop_state(state, live.index(i))
                live.remove(i)
            if not live:
                break

        for i in list(live):
            results[i] = {"steps": max_steps, "distance_to_goal": feeds[i].oracle_distance()}
        return results  # type: ignore[return-value]

    def run_interleaved(self, feeds: Sequence[Feed], groups: int = 2,
                        max_steps: Optional[int] = None,
                        ignore_stop: bool = False) -> List[Dict]:
        """Round-robin episode groups (feeds ``g::groups``) on threads, so
        one group's host work (feed rendering, tokenization) overlaps
        another's device step; results in feed order."""
        groups = max(1, min(groups, len(feeds)))
        parts = [list(range(len(feeds)))[g::groups] for g in range(groups)]
        results: List[Optional[Dict]] = [None] * len(feeds)

        errors: List[BaseException] = []

        def worker(idxs):
            try:
                out = self.run([feeds[i] for i in idxs], max_steps, ignore_stop=ignore_stop)
            except BaseException as e:      # re-raised below, in the caller's thread
                errors.append(e)
                return
            for j, i in enumerate(idxs):
                results[i] = out[j]

        threads = [threading.Thread(target=worker, args=(p,)) for p in parts]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results  # type: ignore[return-value]
