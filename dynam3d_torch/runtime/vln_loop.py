"""VLN training, evaluation and inference over the feed protocol; port of
``runtime/vln_loop.py`` (``VLNTrainer``, ``evaluate``, ``inference``,
``poll_checkpoint_folder``).

The trainer runs teacher-forced episodes with one update per step: the
teacher takes the candidate waypoint nearest the goal (stop within 1.5 m),
from the frozen waypoint predictor over the 12-view depth panorama when the
feed gives one, else from a geometric fan of 12 headings x 3 ranges.  The
feeds rebuild every ``recycle_every`` episodes.  Eval and inference run
``EpisodeRunner`` episodes sharded over ranks and write the stats and path
files, merged over the ranks of a process group.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.models import policy as policy_mod
from dynam3d_torch.models import policy_3dff
from dynam3d_torch.models.encoders.depth_resnet import feature_dim, init_depth_params
from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer, build_prompt
from dynam3d_torch.models.waypoint.trm import (
    Candidates, extract_candidates, init_waypoint_params,
)
from dynam3d_torch.parallel.comm import all_reduce_
from dynam3d_torch.runtime import checkpoint as ckpt_mod
from dynam3d_torch.runtime import metrics as metrics_mod
from dynam3d_torch.runtime import trainer_vln
from dynam3d_torch.runtime.episode import EpisodeRunner
from dynam3d_torch.runtime.feed import STOP, Feed
from dynam3d_torch.utils.actions import (
    EpisodeActionState, gt_text as make_gt_text, parse_action, teacher_targets,
)
from dynam3d_torch.utils.tree import tree_leaves


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class VLNTrainer:
    """Imitation-learning trainer on ``device`` (the card unless
    ``device="cpu"``; ``params`` must live there).

    The trainer owns the trainable tensors of ``params`` (the five
    projector trees and Phi-3) and updates them in place.  Without
    ``waypoint_params`` and ``depth_enc_params`` and with
    ``cfg.train.use_waypoint_predictor``, both are drawn from
    ``cfg.train.seed + 17``.  ``step_log`` records, per step, the loss, grad
    norm, skip flag, the candidates and whether the predictor gave them, the
    gt text, the step's ms (synchronized before and after) and, on the
    card, the peak of allocated memory so far (``torch.cuda`` counts it
    from the caller's last reset).

    Data-parallel training (``dp``: a process group; every rank builds its
    trainer from the same weights, one episode at a time on its own feed):
    each step averages the ranks' gradients (``make_train_step``), so the
    replicas stay identical.  Teacher-forced episodes differ in length (and
    so may the ranks' ``max_steps``), so the ranks step in lockstep by this
    rule: before each step of an episode the ranks all-reduce whether any
    of them is still in its episode; if none is, the episode ends on every
    rank; otherwise a rank whose episode has ended runs an idle step (zero
    gradients at weight 0, no perception, no log entry, counted in
    ``idle_steps``), and the others train on their rows.  A step whose
    teacher label is ``"error."`` (a looping episode) ends the episode
    without an update, so under ``dp`` it is such an idle step too.  Rank 0 saves the
    checkpoints (whole trees, the format of a one-process run); ``resume``
    loads on every rank."""

    def __init__(self, params, cfg: Dynam3DConfig, feed_factory: Callable[[], Feed],
                 tokenizer=None, recycle_every: Optional[int] = None, rank: int = 0,
                 world: int = 1, waypoint_params=None, depth_enc_params=None,
                 device: DeviceLike = None, dp=None):
        self.device = resolve_device(device)
        self.dp = dp
        self.cfg = cfg
        self.feed_factory = feed_factory
        self.tok = tokenizer or ByteTokenizer(cfg.llava.phi3.vocab_size)
        self.recycle_every = recycle_every or cfg.train.recycle_every
        self.rank = rank
        self.world = world
        self.n_mm = (cfg.fields.input_height * cfg.fields.input_width
                     + policy_mod.I_ENV + policy_mod.Z_ENV)
        probe = self.tok.encode(build_prompt("x", ["none\n"] * 4, 1))
        self.splice_start = probe.index(self.tok.image_id)

        self.trainable, self.frozen = trainer_vln.split_params(params)
        self.optimizer = trainer_vln.make_optimizer(cfg)
        self.opt_state = self.optimizer.init(self.trainable)
        self._step_fn = trainer_vln.make_train_step(cfg, self.optimizer, self.splice_start,
                                                    dp=dp)
        if (waypoint_params is None and depth_enc_params is None
                and cfg.train.use_waypoint_predictor):
            gen = torch.Generator(device=self.device).manual_seed(cfg.train.seed + 17)
            depth_enc_params = init_depth_params(gen, cfg.depth, self.device)
            waypoint_params = init_waypoint_params(
                gen, cfg.waypoint, depth_feat_dim=feature_dim(cfg.depth), device=self.device)
        self.waypoint_params = waypoint_params
        self.depth_enc_params = depth_enc_params
        self._waypoint_fn = (self._waypoint_candidates
                             if waypoint_params is not None and depth_enc_params is not None
                             else None)
        self._episodes_done = 0
        self.idle_steps = 0
        self.logs: Dict[str, List[float]] = {"IL_loss": []}
        self.step_log: List[Dict] = []

    @torch.no_grad()
    def waypoint_heatmap(self, dep12: torch.Tensor) -> torch.Tensor:
        """Heatmap logits ``[1, 120, 12]`` of a ``[1, 12, Hd, Wd]``
        normalized depth panorama (counter-clockwise sensor order)."""
        return policy_3dff.waypoint_heatmap(
            {"depth_enc": self.depth_enc_params, "waypoint": self.waypoint_params}, self.cfg, dep12)

    def _waypoint_candidates(self, dep12: torch.Tensor) -> Candidates:
        return extract_candidates(self.cfg.waypoint, self.waypoint_heatmap(dep12))

    def _tokenize_full(self, instruction: str, history: List[str], gt: str):
        """Prompt + gt ids ``[1, T]`` (T rounded up to the prefill bucket)
        and the gt ids ``[1, Tg]`` (Tg rounded up to 16) with their masks."""
        instruction = instruction[: self.cfg.train.max_text_len]
        ids = self.tok.encode(build_prompt(instruction, history, self.n_mm, gt))
        label_ids = self.tok.encode(gt, add_bos=False)
        T = _round_up(len(ids), self.cfg.llava.prefill_bucket)
        a = np.full((1, T), self.tok.pad_id, np.int64)
        v = np.zeros((1, T), bool)
        a[0, : len(ids)] = ids
        v[0, : len(ids)] = True
        Tg = _round_up(max(len(label_ids), 1), 16)
        lab = np.full((1, Tg), self.tok.pad_id, np.int64)
        lmask = np.zeros((1, Tg), bool)
        lab[0, : len(label_ids)] = label_ids
        lmask[0, : len(label_ids)] = True
        return tuple(torch.from_numpy(x).to(self.device) for x in (a, v, lab, lmask))

    def params(self):
        return trainer_vln.merge_params(self.trainable, self.frozen)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _any_live(self, live: bool) -> bool:
        """Whether any rank of the dp group is still in its episode."""
        flag = torch.tensor([1.0 if live else 0.0], device=self.device)
        return bool(all_reduce_(flag, self.dp, "live") > 0)

    def train_episode(self, feed: Optional[Feed] = None, max_steps: Optional[int] = None) -> Dict:
        """One teacher-forced episode with an update per step (in lockstep
        with the other ranks under ``dp``: class docstring)."""
        cfg = self.cfg
        feed = feed or self.feed_factory()
        max_steps = max_steps or cfg.train.max_traj_len
        ep = {"feed": feed, "obs": feed.reset(), "act": EpisodeActionState(),
              "state": policy_mod.batched_init_state(cfg, 1, self.device), "losses": []}
        self._episodes_done += 1
        live, stepk = True, 0
        while True:
            live = live and stepk < max_steps
            if not (self._any_live(live) if self.dp is not None else live):
                break
            if live:
                live = self._teacher_step(ep, stepk, max_steps)
            else:
                self._idle_step(ep)
            stepk += 1
        losses = ep["losses"]
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        mean_loss *= cfg.train.ml_weight
        self.logs["IL_loss"].append(mean_loss)
        return {"loss": mean_loss, "steps": len(losses)}

    def _idle_step(self, ep: Dict) -> None:
        """A data-parallel step with nothing to contribute: zero gradients
        at weight 0 into the group's collectives."""
        self._step_fn(self.trainable, self.frozen, self.opt_state, ep["state"], None)
        self.idle_steps += 1

    def _teacher_step(self, ep: Dict, stepk: int, max_steps: int) -> bool:
        """One teacher-forced step of the episode ``ep`` (its feed,
        observation, action state, memory and losses, updated); whether the
        episode goes on."""
        cfg, dev = self.cfg, self.device
        feed, obs, act_state = ep["feed"], ep["obs"], ep["act"]
        cands, from_predictor = self._candidates(feed, obs)
        dists = [feed.cand_dist_to_goal(a, d) for a, d in zip(*cands)]
        oracle = STOP if feed.oracle_distance() < 1.5 else int(np.argmin(dists))
        angle, dist, stop = teacher_targets(act_state, cands[0], cands[1], oracle)
        gt = make_gt_text(act_state, angle, dist, stop, cfg.action)
        if gt.startswith("error."):
            self.feed_factory()      # the reference draws a new feed here
            if self.dp is not None:  # the live peers step now: keep the collectives matched
                self._idle_step(ep)
            return False

        ids, tvalid, labels, label_mask = self._tokenize_full(
            obs.instruction, act_state.history_actions, gt)
        turn_w = 0.0 if ("stop" in gt or "error" in gt) else 1.0
        # the policy sees the forward view only; a 12-view feed is for
        # the waypoint predictor's panorama
        batch = trainer_vln.TrainBatch(
            rgb=torch.from_numpy(np.ascontiguousarray(obs.rgb[None, :1])).to(dev),
            depth=torch.from_numpy(np.ascontiguousarray(obs.depth[None, :1])).to(dev),
            position=torch.from_numpy(np.asarray(obs.position, np.float32)[None]).to(dev),
            heading=torch.tensor([obs.heading], dtype=torch.float32, device=dev),
            input_ids=ids, text_valid=tvalid, label_ids=labels, label_mask=label_mask,
            turn_weight=torch.tensor([turn_w], dtype=torch.float32, device=dev),
        )
        self._sync()
        t0 = time.perf_counter()
        self.trainable, self.opt_state, ep["state"], m = self._step_fn(
            self.trainable, self.frozen, self.opt_state, ep["state"], batch)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(m["loss"])
        ep["losses"].append(loss)
        self.step_log.append({
            "episode": self._episodes_done, "step": stepk, "gt": gt, "loss": loss,
            "grad_norm": float(m["grad_norm"]), "skipped": m["skipped"], "ms": ms,
            "candidates": [list(c) for c in cands], "from_predictor": from_predictor,
            "tokens": int(tvalid.sum()),
            "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else None),
        })
        act_state.push_history(gt.replace("<|end|>", "\n"))

        action = parse_action(gt, cfg.action)
        if action == STOP or stepk == max_steps - 1:
            feed.step(STOP)
            return False
        ep["obs"], done, _ = feed.step(action)
        return not done

    def _candidates(self, feed: Feed, obs):
        """``((angles, distances), from_predictor)``: the waypoint
        predictor's picks over a 12-view depth panorama when it finds any,
        else the geometric 12-heading x 3-range fan."""
        if self._waypoint_fn is not None and obs.depth.shape[0] == 12:
            c = self._waypoint_fn(torch.from_numpy(np.ascontiguousarray(obs.depth[None]))
                                  .to(self.device))
            m = c.mask[0].cpu().numpy()
            if m.any():
                return ((c.angles_ccw[0].cpu().numpy()[m].tolist(),
                         c.distances[0].cpu().numpy()[m].tolist()), True)
        ca, cd = [], []
        for i in range(12):
            for d in (0.25, 0.75, 1.5):
                ca.append(i * (2 * np.pi / 12))
                cd.append(d)
        return (ca, cd), False

    def train(self, iters: int, log_every: Optional[int] = None,
              ckpt_dir: Optional[str] = None) -> None:
        """``iters`` episodes; rank 0 saves ``{"trainable", "opt_state"}``
        every ``log_every`` of them."""
        log_every = log_every or self.cfg.train.log_every
        feed = self.feed_factory()
        for it in range(iters):
            if self._episodes_done % self.recycle_every == 0:
                feed = self.feed_factory()
            self.train_episode(feed)
            if ckpt_dir and (it + 1) % log_every == 0 and self.rank == 0:
                ckpt_mod.save_checkpoint(ckpt_dir, it + 1, {"trainable": self.trainable,
                                                            "opt_state": self.opt_state})

    def run(self) -> int:
        """The training run of ``cfg.train`` (the reference's ``run.py``
        train mode): with ``is_requeue``, resume from the newest checkpoint
        of ``ckpt_dir``, then train up to ``iters`` episodes in all, saving
        under ``ckpt_dir``.  Returns the step resumed from (0 when none)."""
        t = self.cfg.train
        start = self.resume(t.ckpt_dir) if t.is_requeue else 0
        self.train(t.iters - start, ckpt_dir=t.ckpt_dir)
        return start

    def resume(self, ckpt_dir: str) -> int:
        """Load the newest checkpoint of ``ckpt_dir`` into the trainable
        tensors and the optimizer state (in place); returns its step, 0
        when there is none."""
        path = ckpt_mod.newest_checkpoint(ckpt_dir)
        if path is None:
            return 0
        current = {"trainable": self.trainable, "opt_state": self.opt_state}
        restored = ckpt_mod.load_checkpoint(path, current)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(current), tree_leaves(restored)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        self.opt_state["count"] = restored["opt_state"]["count"]
        return ckpt_mod.checkpoint_step(path)


def _gather_by_index(items: Dict[int, object], dp) -> List[tuple]:
    """``(index, value)`` pairs of every rank of ``dp`` (this rank's alone
    when ``dp`` is None), in index order, on every rank."""
    mine = sorted(items.items())
    if dp is None:
        return mine
    import torch.distributed as dist

    parts = [None] * dist.get_world_size(dp)
    dist.all_gather_object(parts, mine, group=dp)
    return sorted(pair for part in parts for pair in part)


def evaluate(params, cfg: Dynam3DConfig, feeds: Sequence[Feed], gt_paths: Sequence[np.ndarray],
             tokenizer=None, out_dir: Optional[str] = None, ckpt_name: str = "ckpt",
             rank: int = 0, world: int = 1, fast_eval: bool = False, ignore_stop: bool = False,
             device: DeviceLike = None, dp=None) -> Dict[str, float]:
    """Evaluation: this rank's episodes (``feeds[rank::world]``, every
    ``fast_eval_stride``-th with ``fast_eval``), per-episode metrics
    written to ``stats_ep_{ckpt}_r{rank}_w{world}.json`` under ``out_dir``,
    and their mean to ``stats_{ckpt}.json``.  With a process group ``dp``
    the ranks' per-episode metrics are gathered: every rank returns the
    mean over all episodes (the reference's weighted merge) and only rank
    0 writes ``stats_{ckpt}.json``.  ``ignore_stop`` goes to
    ``EpisodeRunner.run``."""
    idxs = metrics_mod.shard_episodes(range(len(feeds)), rank, world)
    if fast_eval:
        idxs = idxs[:: cfg.eval.fast_eval_stride]
    runner = EpisodeRunner(params, cfg, tokenizer, device=device)
    stat_eps: Dict[str, Dict[str, float]] = {}
    for i in idxs:
        res = runner.run([feeds[i]], max_steps=cfg.train.max_traj_len, ignore_stop=ignore_stop)[0]
        pred_path = np.asarray(res.get("position", [[0, 0, 0]]), np.float32)
        dists = np.asarray([feeds[i].oracle_distance(p) for p in pred_path], np.float32)
        stat_eps[str(i)] = metrics_mod.episode_metrics(
            pred_path, dists, gt_paths[i], res["steps"],
            collisions=int(res.get("collisions", 0)),
            success_distance=cfg.eval.success_distance)
    merged = _gather_by_index({int(i): m for i, m in stat_eps.items()}, dp)
    agg = metrics_mod.aggregate([m for _, m in merged])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"stats_ep_{ckpt_name}_r{rank}_w{world}.json"), "w") as f:
            json.dump(stat_eps, f, indent=2)
        if dp is None or rank == 0:
            with open(os.path.join(out_dir, f"stats_{ckpt_name}.json"), "w") as f:
                json.dump(agg, f, indent=2)
    return agg


def inference(params, cfg: Dynam3DConfig, feeds: Sequence[Feed], episode_ids: Sequence[str],
              tokenizer=None, out_path: Optional[str] = None, rank: int = 0, world: int = 1,
              fmt: str = "r2r", device: DeviceLike = None, dp=None) -> Dict[str, list]:
    """Inference: each episode's path with consecutive duplicates
    dropped, at most ``max_infer_positions`` poses.  ``fmt="r2r"`` writes
    one JSON dict of paths; ``fmt="rxr"`` JSON lines ``{"instruction_id",
    "path": [[x, y, z], ...]}``.  With a process group ``dp`` the ranks'
    paths are gathered: every rank returns all of them and only rank 0
    writes ``out_path``, in episode order."""
    idxs = metrics_mod.shard_episodes(range(len(feeds)), rank, world)
    runner = EpisodeRunner(params, cfg, tokenizer, device=device)
    mine: Dict[int, list] = {}
    for i in idxs:
        res = runner.run([feeds[i]], max_steps=cfg.train.max_traj_len)[0]
        pos = res.get("position", [[0.0, 0.0, 0.0]])
        hds = res.get("heading", [0.0] * len(pos))
        mine[i] = metrics_mod.dedup_path(pos, hds, cfg.eval.max_infer_positions)
    paths = {str(episode_ids[i]): path for i, path in _gather_by_index(mine, dp)}
    if out_path and (dp is None or rank == 0):
        with open(out_path, "w") as f:
            if fmt == "rxr":
                for ep_id, path in paths.items():
                    f.write(json.dumps({"instruction_id": ep_id,
                                        "path": [p["position"] for p in path]}) + "\n")
            else:
                json.dump(paths, f)
    return paths


def poll_checkpoint_folder(ckpt_dir: str, seen: set, poll_s: float = 2.0,
                           timeout_s: Optional[float] = None):
    """Yield the ``ckpt.iter*`` files of ``ckpt_dir`` not in ``seen``, by
    mtime, as they appear; stops after ``timeout_s`` (never when None)."""
    start = time.time()
    while True:
        for c in sorted(glob.glob(os.path.join(ckpt_dir, "ckpt.iter*")), key=os.path.getmtime):
            if c not in seen:
                seen.add(c)
                yield c
        if timeout_s is not None and time.time() - start > timeout_s:
            return
        time.sleep(poll_s)
