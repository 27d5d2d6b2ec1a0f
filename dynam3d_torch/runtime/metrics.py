"""VLN-CE episode metrics; own copy of ``runtime/metrics.py``: steps
taken, distance to goal, success within ``success_distance``, oracle
success, path length, collision rate, SPL, nDTW and SDTW.

nDTW = exp(-DTW(pred, gt) / (len(gt) * success_distance)), with an exact
O(nm) numpy DTW (paths hold at most 500 poses).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def euclidean_dtw(pred: np.ndarray, gt: np.ndarray) -> float:
    """Exact DTW with the euclidean point distance, in float64."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    n, m = len(pred), len(gt)
    d = np.linalg.norm(pred[:, None, :] - gt[None, :, :], axis=-1)
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            acc[i, j] = d[i - 1, j - 1] + min(acc[i - 1, j], acc[i - 1, j - 1], acc[i, j - 1])
    return float(acc[n, m])


def ndtw(pred_path: np.ndarray, gt_path: np.ndarray, success_distance: float = 3.0) -> float:
    dtw = euclidean_dtw(pred_path, gt_path)
    return float(np.exp(-dtw / (len(gt_path) * success_distance)))


def episode_metrics(pred_path: np.ndarray, distances_to_goal: np.ndarray,
                    gt_path: np.ndarray, steps_taken: int, collisions: int = 0,
                    success_distance: float = 3.0) -> Dict[str, float]:
    """Metrics of one episode from its positions ``[T, 3]`` (start
    included), the distance to the goal at each and the reference path."""
    pred_path = np.asarray(pred_path, np.float32)
    distances = np.asarray(distances_to_goal, np.float32)
    m: Dict[str, float] = {}
    m["steps_taken"] = float(steps_taken)
    m["distance_to_goal"] = float(distances[-1])
    m["success"] = 1.0 if distances[-1] <= success_distance else 0.0
    m["oracle_success"] = 1.0 if (distances <= success_distance).any() else 0.0
    m["path_length"] = float(np.linalg.norm(pred_path[1:] - pred_path[:-1], axis=1).sum())
    m["collisions"] = collisions / max(len(pred_path), 1)
    gt_length = float(distances[0])
    m["spl"] = m["success"] * gt_length / max(gt_length, m["path_length"], 1e-9)
    m["ndtw"] = ndtw(pred_path, np.asarray(gt_path, np.float32), success_distance)
    m["sdtw"] = m["ndtw"] * m["success"]
    return m


def aggregate(per_episode: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Mean of each metric over episodes."""
    if not per_episode:
        return {}
    keys = per_episode[0].keys()
    return {k: float(np.mean([e[k] for e in per_episode])) for k in keys}


def shard_episodes(episode_ids: Sequence, rank: int, world: int) -> list:
    """Strided sharding ``ids[rank::world]``."""
    return list(episode_ids)[rank::world]


def dedup_path(positions: Sequence[Sequence[float]], headings: Sequence[float],
               max_len: int = 500) -> list:
    """Inference path: consecutive duplicate positions dropped, at most
    ``max_len`` poses, the last marked as the stop."""
    out = [{"position": list(positions[0]), "heading": float(headings[0]), "stop": False}]
    for p, h in zip(positions[1:], headings[1:]):
        if list(p) != out[-1]["position"]:
            out.append({"position": list(p), "heading": float(h), "stop": False})
    out = out[:max_len]
    out[-1]["stop"] = True
    return out
