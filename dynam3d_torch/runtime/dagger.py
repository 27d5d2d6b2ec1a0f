"""DAgger trajectory collection and replay; port of ``runtime/dagger.py``,
itself the port of the legacy ``DaggerTrainer`` (vlnce_baselines/dagger_trainer.py:186+,
registered "dagger" but unselected by shipped configs — SURVEY.md §2.1) and
the ``TeacherRecollectionDataset`` pipeline (common/recollection_dataset.py):
the reference collects (obs, teacher-action) tuples into lmdb with
msgpack; here trajectories go into the port's episode store
(``runtime/episode_store.py``), which training replays.

Step record layout (raw little-endian, fixed stride):
    rgb u8 [V,H,W,3] | depth f32 [V,Hd,Wd] | position f32[3] | heading f32 |
    gt_text utf-8 padded to 64 bytes
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.runtime.episode_store import EpisodeStore, write_episode_store
from dynam3d_torch.runtime.feed import STOP, Feed
from dynam3d_torch.utils.actions import (
    EpisodeActionState,
    gt_text as make_gt_text,
    parse_action,
    teacher_targets,
)

GT_TEXT_BYTES = 64


def _pack_step(obs, gt: str) -> bytes:
    parts = [
        np.ascontiguousarray(obs.rgb, np.uint8).tobytes(),
        np.ascontiguousarray(obs.depth, np.float32).tobytes(),
        np.asarray(obs.position, np.float32).tobytes(),
        np.float32(obs.heading).tobytes(),
        gt.encode("utf-8")[:GT_TEXT_BYTES].ljust(GT_TEXT_BYTES, b"\0"),
    ]
    return b"".join(parts)


def unpack_step(blob: bytes, meta: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, str]:
    V, H, W = meta["views"], meta["rgb_size"], meta["rgb_size"]
    Hd = meta["depth_size"]
    o = 0
    rgb = np.frombuffer(blob, np.uint8, V * H * W * 3, o).reshape(V, H, W, 3)
    o += V * H * W * 3
    depth = np.frombuffer(blob, np.float32, V * Hd * Hd, o).reshape(V, Hd, Hd)
    o += V * Hd * Hd * 4
    pos = np.frombuffer(blob, np.float32, 3, o).copy()
    o += 12
    heading = float(np.frombuffer(blob, np.float32, 1, o)[0])
    o += 4
    gt = blob[o : o + GT_TEXT_BYTES].split(b"\0")[0].decode("utf-8")
    return rgb, depth, pos, heading, gt


def collect_trajectories(
    cfg: Dynam3DConfig,
    feed_factory: Callable[[], Feed],
    out_path: str,
    episodes: int = 10,
    max_steps: Optional[int] = None,
    candidate_fn: Optional[Callable] = None,
) -> int:
    """Teacher-policy rollouts -> episode store (dagger_trainer's lmdb
    collection loop).  Returns the number of stored steps."""
    max_steps = max_steps or cfg.train.max_traj_len
    steps: List[bytes] = []
    meta: Dict = {}
    for _ in range(episodes):
        feed = feed_factory()
        obs = feed.reset()
        meta = {
            "views": obs.rgb.shape[0],
            "rgb_size": obs.rgb.shape[1],
            "depth_size": obs.depth.shape[1],
            "gt_text_bytes": GT_TEXT_BYTES,
            "instruction": obs.instruction,
        }
        act = EpisodeActionState()
        for stepk in range(max_steps):
            if candidate_fn is not None:
                ca, cd = candidate_fn(feed, obs)
            else:
                ca = [i * (2 * np.pi / 12) for i in range(12) for _ in range(3)]
                cd = [0.25, 0.75, 1.5] * 12
            dists = [feed.cand_dist_to_goal(a, d) for a, d in zip(ca, cd)]
            oracle = STOP if feed.oracle_distance() < 1.5 else int(np.argmin(dists))
            angle, dist, stop = teacher_targets(act, ca, cd, oracle)
            gt = make_gt_text(act, angle, dist, stop, cfg.action)
            steps.append(_pack_step(obs, gt))
            act.push_history(gt.replace("<|end|>", "\n"))
            action = parse_action(gt, cfg.action)
            if action == STOP or stepk == max_steps - 1:
                feed.step(STOP)
                break
            obs, done, _ = feed.step(action)
            if done:
                break

    write_episode_store(out_path, steps, meta)
    return len(steps)


def iterate_store(path: str, prefetch_ahead: int = 4):
    """Replay collected steps (TeacherRecollectionDataset equivalent)."""
    store = EpisodeStore(path, prefetch_ahead)
    try:
        for t in range(store.n_steps):
            yield unpack_step(store.read(t), store.meta), store.meta
    finally:
        store.close()
