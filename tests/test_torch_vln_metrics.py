"""Episode metrics and action-text codecs of the port against the JAX
package's, exactly: DTW / nDTW (the port's numpy DTW against the
reference's numpy DTW, and against its native DTW, which the reference
takes when built), ``episode_metrics``, ``aggregate``, ``shard_episodes``,
``dedup_path``, ``gt_text``, ``teacher_targets`` and ``parse_action``."""

import math

import numpy as np
import pytest

from dynam3d_tpu.runtime import metrics as jm
from dynam3d_tpu.utils import actions as ja
from dynam3d_torch.runtime import metrics as tm
from dynam3d_torch.utils import actions as ta


def _paths(seed, n, m):
    rng = np.random.default_rng(seed)
    pred = np.cumsum(rng.normal(0, 0.5, (n, 3)), axis=0).astype(np.float32)
    gt = np.cumsum(rng.normal(0, 0.5, (m, 3)), axis=0).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("n,m", [(1, 1), (7, 3), (40, 25)])
def test_dtw_and_ndtw_match(n, m, monkeypatch):
    pred, gt = _paths(n * 100 + m, n, m)
    got = tm.euclidean_dtw(pred, gt)
    if jm._dtw_native is not None:
        assert got == jm.euclidean_dtw(pred, gt)
    monkeypatch.setattr(jm, "_dtw_native", None)
    assert got == jm.euclidean_dtw(pred, gt)
    assert tm.ndtw(pred, gt, 3.0) == jm.ndtw(pred, gt, 3.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_episode_metrics_and_aggregate_match(seed):
    eps_t, eps_j = [], []
    for k in range(3):
        pred, gt = _paths(seed * 10 + k, 6 + k, 4)
        dists = np.linalg.norm(pred[:, [0, 2]] - gt[-1, [0, 2]], axis=1)
        if k == 1:
            dists[-1] = 2.0                      # a success
        args = (pred, dists, gt, 5 + k)
        t = tm.episode_metrics(*args, collisions=k, success_distance=3.0)
        j = jm.episode_metrics(*args, collisions=k, success_distance=3.0)
        assert t == j
        eps_t.append(t)
        eps_j.append(j)
    assert tm.aggregate(eps_t) == jm.aggregate(eps_j)
    assert tm.aggregate([]) == jm.aggregate([]) == {}


def test_shard_and_dedup_match():
    for rank, world in ((0, 1), (1, 3), (2, 3)):
        assert tm.shard_episodes(range(10), rank, world) == jm.shard_episodes(range(10), rank, world)
    pos = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.5], [1.0, 0.0, 0.5], [2.0, 0.0, 1.0]]
    hd = [0.0, 0.1, 0.2, 0.3, 0.4]
    for cap in (500, 2):
        assert tm.dedup_path(pos, hd, cap) == jm.dedup_path(pos, hd, cap)


def test_gt_text_and_teacher_targets_match():
    """Every 5-degree heading and a few distances from a fresh state, then a
    sequence through one carried state (split turns and the loop check)."""
    for deg in range(0, 360, 5):
        for dist in (0.25, 1.0, 2.75):
            st, sj = ta.EpisodeActionState(), ja.EpisodeActionState()
            a = math.radians(deg)
            assert ta.gt_text(st, a, dist, False) == ja.gt_text(sj, a, dist, False)
            assert st.keep_target_waypoint == sj.keep_target_waypoint
    st, sj = ta.EpisodeActionState(), ja.EpisodeActionState()
    cands = ([0.3, 2.0, 4.5], [0.5, 1.25, 2.0])
    texts = []
    for oracle in (2, 1, 1, 0, 0, 0, 0, -100):
        t = ta.teacher_targets(st, *cands, oracle)
        j = ja.teacher_targets(sj, *cands, oracle)
        assert t == j
        tt, tj = ta.gt_text(st, *t), ja.gt_text(sj, *j)
        assert tt == tj
        texts.append(tt)
        st.push_history(tt.replace("<|end|>", "\n"))
        sj.push_history(tj.replace("<|end|>", "\n"))
        assert (st.keep_target_waypoint, st.history_actions) == \
            (sj.keep_target_waypoint, sj.history_actions)
    # the walk covers a split turn, the loop check and the stop
    assert "turn right 7 steps, move 8 steps.<|end|>" in texts
    assert "error.<|end|>" in texts and texts[-1] == "stop.<|end|>"


@pytest.mark.parametrize("text", ["turn left 3 steps, move 2 steps.", "turn right 6 steps, move 1 steps.",
                                  "stop.", "error.", "move 2 steps.", "turn left 2", "garbage"])
def test_parse_action_matches(text):
    assert ta.parse_action(text) == ja.parse_action(text)
