"""Greedy shortest-path follower; own copy of ``utils/follower.py``, the
port of ``ShortestPathFollowerCompat`` (habitat_extensions/
shortest_path_follower.py:25-180): pick the discrete action (or continuous
(angle, distance) pair) that greedily minimizes the oracle distance-to-goal.
Works over any Feed exposing ``cand_dist_to_goal`` / ``oracle_distance``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from dynam3d_torch.runtime.feed import STOP, Feed


class ShortestPathFollower:
    def __init__(
        self,
        goal_radius: float = 1.5,
        turn_angle_deg: float = 15.0,
        forward_step: float = 0.25,
    ):
        self.goal_radius = goal_radius
        self.turn_angle = math.radians(turn_angle_deg)
        self.forward_step = forward_step

    def next_action(
        self, feed: Feed,
        candidates: Optional[Sequence[Tuple[float, float]]] = None,
    ) -> Union[int, Tuple[float, float]]:
        """Greedy (angle, distance) toward the goal, or STOP in range."""
        if feed.oracle_distance() < self.goal_radius:
            return STOP
        if candidates is None:
            candidates = [
                (a, d)
                for a in np.arange(0, 2 * math.pi, self.turn_angle)
                for d in (self.forward_step, 3 * self.forward_step,
                          6 * self.forward_step)
            ]
        dists = [feed.cand_dist_to_goal(a, d) for a, d in candidates]
        return candidates[int(np.argmin(dists))]

    def discrete_action(self, feed: Feed) -> int:
        """Legacy discrete interface: 0 stop, 1 forward, 2 left, 3 right."""
        act = self.next_action(feed)
        if act == STOP:
            return 0
        angle, _ = act
        if angle < self.turn_angle / 2 or angle > 2 * math.pi - self.turn_angle / 2:
            return 1
        return 2 if angle <= math.pi else 3
