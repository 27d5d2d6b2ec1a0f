"""Host-side simulator feed; own copy of ``runtime/feed.py``
(``Observation``, ``Feed``, ``SyntheticRoomFeed``, ``STOP``).

:class:`SyntheticRoomFeed` is an analytic box room: depth from ray-wall
intersections, procedural RGB keyed by pose, euclidean oracle distance.
Actions turn to ``heading + angle`` then move ``distance`` forward, clipped
by the walls; ``STOP`` ends the episode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Protocol, Tuple, Union

import numpy as np

STOP = -100


@dataclasses.dataclass
class Observation:
    rgb: np.ndarray          # [V,H,W,3] uint8
    depth: np.ndarray        # [V,Hd,Wd] float32 in [0,1] (metric/10)
    position: np.ndarray     # [3] habitat-frame (x, y-up, z)
    heading: float
    instruction: str


class Feed(Protocol):
    def reset(self) -> Observation: ...

    def step(self, action: Union[int, Tuple[float, float]]) -> Tuple[Observation, bool, Dict]: ...

    def oracle_distance(self, position: np.ndarray) -> float: ...


class SyntheticRoomFeed:
    """Analytic rectangular room with textured walls and a goal point.

    Geometry: room [0,Lx] x [0,Lz] in the habitat ground plane (x,z), agent
    at eye height.  Depth is the exact ray distance to the nearest wall,
    normalized by max_depth (as Habitat's depth sensor does).
    """

    def __init__(
        self,
        rgb_size: int = 336,
        depth_size: int = 256,
        views: int = 1,
        room: Tuple[float, float] = (8.0, 8.0),
        goal: Tuple[float, float] = (6.0, 6.0),
        start: Tuple[float, float] = (2.0, 2.0),
        instruction: str = "walk forward and stop at the far corner.",
        max_depth: float = 10.0,
        hfov_deg: float = 90.0,
        seed: int = 0,
    ):
        self.rgb_size = rgb_size
        self.depth_size = depth_size
        self.views = views
        self.room = room
        self.goal = np.asarray([goal[0], 1.25, goal[1]], np.float32)
        self.start = start
        self.instruction = instruction
        self.max_depth = max_depth
        self.hfov = math.radians(hfov_deg)
        self.rng = np.random.default_rng(seed)
        self.positions: List[np.ndarray] = []
        self.headings: List[float] = []
        self.collisions = 0
        self._pos = np.zeros(3, np.float32)
        self._heading = 0.0

    # --- geometry helpers -------------------------------------------------
    def _wall_distance(self, x: float, z: float, dx: float, dz: float) -> float:
        """Distance along (dx,dz) from (x,z) to the room boundary."""
        ts = []
        if dx > 1e-9:
            ts.append((self.room[0] - x) / dx)
        elif dx < -1e-9:
            ts.append(-x / dx)
        if dz > 1e-9:
            ts.append((self.room[1] - z) / dz)
        elif dz < -1e-9:
            ts.append(-z / dz)
        return max(min(ts), 0.05) if ts else self.max_depth

    def _render(self) -> Observation:
        V = self.views
        D = self.depth_size
        depth = np.zeros((V, D, D), np.float32)
        rgb = np.zeros((V, self.rgb_size, self.rgb_size, 3), np.uint8)
        x, z = float(self._pos[0]), float(self._pos[2])
        for v in range(V):
            # habitat pano convention: view v at heading + v*(-pi/6)
            h = self._heading + v * (-math.pi / 6.0)
            # camera forward in ground plane: heading 0 faces -z (habitat);
            # in our world frame the update path swaps axes, so emit depth
            # consistent with unproject_depth_habitat: columns fan over hfov
            cols = (np.arange(D) + 0.5) / D * 2.0 - 1.0
            angles = np.arctan(cols * math.tan(self.hfov / 2.0))
            for ci, a in enumerate(angles):
                wh = h + a
                dx = -math.sin(wh)
                dz = -math.cos(wh)
                t = self._wall_distance(x, z, dx, dz)
                ray = min(t * math.cos(a), self.max_depth)  # planar depth
                depth[v, :, ci] = ray / self.max_depth
            # procedural texture keyed by pose so CLIP features vary
            key = np.float32([x, z, h])
            base = (np.sin(np.arange(self.rgb_size) * 0.3 + key[0]) * 60 + 120)
            rgb[v] = np.clip(
                base[None, :, None]
                + np.cos(np.arange(self.rgb_size) * 0.17 + key[1])[:, None, None] * 50
                + np.float32([0, 40, 80]) * math.sin(h),
                0,
                255,
            ).astype(np.uint8)
        return Observation(
            rgb=rgb,
            depth=depth,
            position=self._pos.copy(),
            heading=self._heading,
            instruction=self.instruction,
        )

    # --- Feed protocol ----------------------------------------------------
    def reset(self) -> Observation:
        self._pos = np.asarray([self.start[0], 1.25, self.start[1]], np.float32)
        self._heading = 0.0
        self.positions = [self._pos.copy()]
        self.headings = [0.0]
        self.collisions = 0
        return self._render()

    def step(self, action):
        if action == STOP:
            return self._render(), True, self._info()
        angle, distance = action
        self._heading = (self._heading + angle) % (2 * math.pi)
        dx = -math.sin(self._heading) * distance
        dz = -math.cos(self._heading) * distance
        nx = self._pos[0] + dx
        nz = self._pos[2] + dz
        margin = 0.2
        cx = np.clip(nx, margin, self.room[0] - margin)
        cz = np.clip(nz, margin, self.room[1] - margin)
        if cx != nx or cz != nz:
            self.collisions += 1
        self._pos = np.asarray([cx, self._pos[1], cz], np.float32)
        self.positions.append(self._pos.copy())
        self.headings.append(self._heading)
        return self._render(), False, self._info()

    def oracle_distance(self, position: Optional[np.ndarray] = None) -> float:
        p = self._pos if position is None else position
        return float(np.linalg.norm(np.asarray(p)[[0, 2]] - self.goal[[0, 2]]))

    def get_cand_real_pos(self, angle: float, forward: float):
        """Oracle RPC (environments.py:139-161): resulting position of a
        candidate move, WITHOUT mutating the live state."""
        h = (self._heading + angle) % (2 * math.pi)
        nx = np.clip(self._pos[0] - math.sin(h) * forward, 0.2, self.room[0] - 0.2)
        nz = np.clip(self._pos[2] - math.cos(h) * forward, 0.2, self.room[1] - 0.2)
        return np.asarray([nx, self._pos[1], nz], np.float32)

    def get_observation(self, source_position, heading: float) -> Observation:
        """Oracle RPC (environments.py:55-61): render at an arbitrary pose
        (novel-view sampling for 3DFF pretraining) without moving the agent."""
        saved_pos, saved_heading = self._pos.copy(), self._heading
        self._pos = np.asarray(source_position, np.float32)
        self._heading = float(heading) % (2 * math.pi)
        obs = self._render()
        self._pos, self._heading = saved_pos, saved_heading
        return obs

    def cand_dist_to_goal(self, angle: float, forward: float) -> float:
        """Oracle RPC equivalent (environments.py:259-286): simulate the
        candidate move from the CURRENT state and return distance-to-goal."""
        h = (self._heading + angle) % (2 * math.pi)
        nx = np.clip(self._pos[0] - math.sin(h) * forward, 0.2, self.room[0] - 0.2)
        nz = np.clip(self._pos[2] - math.cos(h) * forward, 0.2, self.room[1] - 0.2)
        return float(
            np.linalg.norm(np.asarray([nx, nz]) - self.goal[[0, 2]])
        )

    def _info(self) -> Dict:
        return {
            "position": [p.tolist() for p in self.positions],
            "heading": list(self.headings),
            "collisions": self.collisions,
            "distance_to_goal": self.oracle_distance(),
        }
