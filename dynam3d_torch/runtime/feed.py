"""Host-side simulator feeds; own copy of ``runtime/feed.py``
(``Observation``, ``Feed``, ``SyntheticRoomFeed``, ``FloorplanFeed``,
``RecordedEpisodeFeed``, ``STOP``).  Feeds are numpy on the host and carry
no tensor.

- :class:`SyntheticRoomFeed` is an analytic box room: depth from ray-wall
  intersections, procedural RGB keyed by pose, euclidean oracle distance.
- :class:`FloorplanFeed` is an occupancy-grid apartment: depth by an exact
  DDA ray walk, a BFS geodesic oracle that bends around walls.
- :class:`RecordedEpisodeFeed` replays an episode saved as ``.npz``.

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


class FloorplanFeed:
    """Occupancy-grid "apartment" simulator: raycast depth over a real
    (non-convex) layout with a BFS geodesic oracle.

    Where :class:`SyntheticRoomFeed` is a convex box (geodesic == euclidean),
    this feed reproduces the property that makes R2R-CE navigation hard and
    that the reference's oracle RPCs expose (environments.py:259-286 returns
    *geodesic* distance-to-goal through doorways): the shortest path bends
    around walls.  Layouts come from ASCII floorplans (``#`` wall, ``.``
    free, ``G`` goal, ``S`` start); depth is exact ray-marched distance to
    the nearest wall cell.
    """

    DEFAULT_PLAN = (
        "####################",
        "#........#.........#",
        "#........#.........#",
        "#........#....G....#",
        "#...S....#.........#",
        "#........#.........#",
        "#........####.######",
        "#..........#.......#",
        "#..........#.......#",
        "######.#####.......#",
        "#..........#.......#",
        "#..................#",
        "#..........#.......#",
        "####################",
    )

    def __init__(
        self,
        plan: Optional[Tuple[str, ...]] = None,
        cell_size: float = 0.5,
        rgb_size: int = 336,
        depth_size: int = 256,
        views: int = 1,
        instruction: str = (
            "exit the room through the doorway, turn right and "
            "stop inside the far room."
        ),
        max_depth: float = 10.0,
        hfov_deg: float = 90.0,
        seed: int = 0,
    ):
        plan = plan or self.DEFAULT_PLAN
        self.grid = np.asarray(
            [[c == "#" for c in row] for row in plan], bool
        )  # [rows(z), cols(x)]
        self.cell = cell_size
        self.rgb_size = rgb_size
        self.depth_size = depth_size
        self.views = views
        self.instruction = instruction
        self.max_depth = max_depth
        self.hfov = math.radians(hfov_deg)
        self.rng = np.random.default_rng(seed)

        def find(ch):
            for r, row in enumerate(plan):
                c = row.find(ch)
                if c != -1:
                    return c, r
            raise ValueError(f"plan has no '{ch}' cell")

        gx, gz = find("G")
        sx, sz = find("S")
        self.goal = np.asarray(
            [(gx + 0.5) * cell_size, 1.25, (gz + 0.5) * cell_size], np.float32
        )
        self.start = ((sx + 0.5) * cell_size, (sz + 0.5) * cell_size)
        self._dist_field = self._bfs_field(gx, gz)
        if not np.isfinite(self._dist_field[sz, sx]):
            raise ValueError("floorplan: start is not connected to the goal")
        self.positions: List[np.ndarray] = []
        self.headings: List[float] = []
        self.collisions = 0
        self._pos = np.zeros(3, np.float32)
        self._heading = 0.0

    # --- geometry ---------------------------------------------------------
    def _bfs_field(self, gx: int, gz: int) -> np.ndarray:
        """4-connected BFS distance (in cells) from the goal over free cells."""
        from collections import deque

        H, W = self.grid.shape
        dist = np.full((H, W), np.inf, np.float32)
        dist[gz, gx] = 0.0
        dq = deque([(gz, gx)])
        while dq:
            r, c = dq.popleft()
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                nr, nc = r + dr, c + dc
                if (
                    0 <= nr < H and 0 <= nc < W
                    and not self.grid[nr, nc]
                    and dist[nr, nc] == np.inf
                ):
                    dist[nr, nc] = dist[r, c] + 1.0
                    dq.append((nr, nc))
        return dist

    def _cell(self, x: float, z: float) -> Tuple[int, int]:
        H, W = self.grid.shape
        return (
            int(np.clip(z / self.cell, 0, H - 1)),
            int(np.clip(x / self.cell, 0, W - 1)),
        )

    def _is_wall(self, x: float, z: float) -> bool:
        r, c = self._cell(x, z)
        return bool(self.grid[r, c])

    def _ray(self, x: float, z: float, dx: float, dz: float) -> float:
        """Distance along (dx,dz) to the first wall face.

        Exact DDA grid walk (Amanatides-Woo): every cell the ray crosses is
        visited, so a grazing ray cannot step across a wall corner the way
        a fixed-step march could — the returned t is the exact boundary
        crossing into the wall cell."""
        H, W = self.grid.shape
        cell = self.cell
        inf = float("inf")
        ix = int(np.clip(math.floor(x / cell), 0, W - 1))
        iz = int(np.clip(math.floor(z / cell), 0, H - 1))
        if self.grid[iz, ix]:
            return 0.0
        step_x = 1 if dx > 0 else -1
        step_z = 1 if dz > 0 else -1
        td_x = cell / abs(dx) if dx else inf   # t per cell crossed in x
        td_z = cell / abs(dz) if dz else inf
        # t of the first boundary crossing on each axis
        tm_x = ((ix + (dx > 0)) * cell - x) / dx if dx else inf
        tm_z = ((iz + (dz > 0)) * cell - z) / dz if dz else inf
        t = 0.0
        while t < self.max_depth:
            if tm_x < tm_z:
                t, tm_x, ix = tm_x, tm_x + td_x, ix + step_x
            else:
                t, tm_z, iz = tm_z, tm_z + td_z, iz + step_z
            if not (0 <= ix < W and 0 <= iz < H):
                return self.max_depth  # left the plan: open space
            if self.grid[iz, ix]:
                return min(t, self.max_depth)
        return self.max_depth

    def _render(self) -> Observation:
        V, D = self.views, self.depth_size
        depth = np.zeros((V, D, D), np.float32)
        rgb = np.zeros((V, self.rgb_size, self.rgb_size, 3), np.uint8)
        x, z = float(self._pos[0]), float(self._pos[2])
        cols = (np.arange(D) + 0.5) / D * 2.0 - 1.0
        col_angles = np.arctan(cols * math.tan(self.hfov / 2.0))
        for v in range(V):
            h = self._heading + v * (-math.pi / 6.0)
            for ci, a in enumerate(col_angles):
                wh = h + a
                t = self._ray(x, z, -math.sin(wh), -math.cos(wh))
                depth[v, :, ci] = min(t * math.cos(a), self.max_depth) / self.max_depth
            # texture keyed by pose + the depth profile so views differ
            key = np.float32([x, z, h])
            base = np.sin(np.arange(self.rgb_size) * 0.21 + key[0]) * 50 + 120
            prof = np.interp(
                np.arange(self.rgb_size), np.linspace(0, self.rgb_size, D),
                depth[v, 0] * 120,
            )
            rgb[v] = np.clip(
                base[None, :, None] + prof[None, :, None]
                + np.float32([30, 0, 60]) * math.sin(h + key[1]),
                0, 255,
            ).astype(np.uint8)
        return Observation(
            rgb=rgb, depth=depth, position=self._pos.copy(),
            heading=self._heading, instruction=self.instruction,
        )

    # --- Feed protocol ----------------------------------------------------
    def reset(self) -> Observation:
        self._pos = np.asarray(
            [self.start[0], 1.25, self.start[1]], np.float32
        )
        self._heading = 0.0
        self.positions = [self._pos.copy()]
        self.headings = [0.0]
        self.collisions = 0
        return self._render()

    def _move(self, x: float, z: float, heading: float, distance: float):
        """Forward move clipped at the first wall; returns (x, z, collided)."""
        dx, dz = -math.sin(heading), -math.cos(heading)
        free = self._ray(x, z, dx, dz)
        margin = self.cell * 0.4
        d = min(distance, max(free - margin, 0.0))
        return x + dx * d, z + dz * d, d < distance - 1e-6

    def step(self, action):
        if action == STOP:
            return self._render(), True, self._info()
        angle, distance = action
        self._heading = (self._heading + angle) % (2 * math.pi)
        nx, nz, hit = self._move(
            float(self._pos[0]), float(self._pos[2]), self._heading, distance
        )
        self.collisions += int(hit)
        self._pos = np.asarray([nx, self._pos[1], nz], np.float32)
        self.positions.append(self._pos.copy())
        self.headings.append(self._heading)
        return self._render(), False, self._info()

    def oracle_distance(self, position: Optional[np.ndarray] = None) -> float:
        """GEODESIC distance-to-goal (BFS cells + in-cell euclidean tail)."""
        p = self._pos if position is None else np.asarray(position)
        r, c = self._cell(float(p[0]), float(p[2]))
        d = float(self._dist_field[r, c])
        if not np.isfinite(d):
            return 1e6
        if d <= 1.0:
            return float(np.linalg.norm(p[[0, 2]] - self.goal[[0, 2]]))
        return d * self.cell

    def get_cand_real_pos(self, angle: float, forward: float):
        h = (self._heading + angle) % (2 * math.pi)
        nx, nz, _ = self._move(
            float(self._pos[0]), float(self._pos[2]), h, forward
        )
        return np.asarray([nx, self._pos[1], nz], np.float32)

    def get_observation(self, source_position, heading: float) -> Observation:
        saved_pos, saved_heading = self._pos.copy(), self._heading
        self._pos = np.asarray(source_position, np.float32)
        self._heading = float(heading) % (2 * math.pi)
        obs = self._render()
        self._pos, self._heading = saved_pos, saved_heading
        return obs

    def cand_dist_to_goal(self, angle: float, forward: float) -> float:
        return self.oracle_distance(self.get_cand_real_pos(angle, forward))

    def _info(self) -> Dict:
        return {
            "position": [p.tolist() for p in self.positions],
            "heading": list(self.headings),
            "collisions": self.collisions,
            "distance_to_goal": self.oracle_distance(),
        }


class RecordedEpisodeFeed:
    """Replays a captured episode from an .npz file.

    Expected arrays: ``rgb [T,V,H,W,3] u8``, ``depth [T,V,Hd,Wd] f32``,
    ``position [T,3]``, ``heading [T]``, plus ``instruction`` (str) and
    optional ``gt_locations [N,3]`` for nDTW and ``goal [3]`` for
    distance-to-goal.  The feed ignores actions and advances one recorded
    step per ``step`` call — the golden-trace harness for parity tests
    without a simulator (SURVEY.md §4).
    """

    def __init__(self, path: str):
        data = np.load(path, allow_pickle=True)
        self.rgb = data["rgb"]
        self.depth = data["depth"]
        self.position = data["position"]
        self.heading = data["heading"]
        self.instruction = str(data["instruction"])
        self.gt_locations = data.get("gt_locations")
        self.goal = data["goal"] if "goal" in data else None
        self._t = 0

    def reset(self) -> Observation:
        self._t = 0
        return self._obs()

    def _obs(self) -> Observation:
        t = self._t
        return Observation(
            rgb=self.rgb[t],
            depth=self.depth[t],
            position=self.position[t],
            heading=float(self.heading[t]),
            instruction=self.instruction,
        )

    def step(self, action):
        self._t = min(self._t + 1, len(self.rgb) - 1)
        done = self._t >= len(self.rgb) - 1 or action == STOP
        return self._obs(), done, self._info()

    def _info(self) -> Dict:
        t = self._t
        return {
            "position": [p.tolist() for p in self.position[: t + 1]],
            "heading": [float(h) for h in self.heading[: t + 1]],
            "collisions": 0,
        }

    def oracle_distance(self, position=None) -> float:
        if self.goal is None:
            return 0.0
        p = self.position[self._t] if position is None else np.asarray(position)
        return float(np.linalg.norm(p[[0, 2]] - np.asarray(self.goal)[[0, 2]]))
