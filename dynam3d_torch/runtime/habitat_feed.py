"""Habitat-sim adapter for the Feed protocol; own copy of
``runtime/habitat_feed.py`` (``heading_to_quat``, ``quat_to_heading``,
``HabitatFeed``, ``feeds_from_episode_file``).

It drives ``habitat_sim.Simulator`` directly, the layer the reference's
habitat-lab wrappers reach (vlnce_baselines/common/environments.py:46-243):

- ``step((angle, dist))``: MoveHighToLow (habitat_extensions/nav.py:28-95):
  set the absolute heading to ``heading + angle``, then ``int(dist //
  0.25)`` MOVE_FORWARD steps with sliding collision; a step that moves
  less than half its length counts as a collision;
- ``cand_dist_to_goal`` / ``get_cand_real_pos`` (environments.py:120-147,
  :180-202): the candidate move simulated from a saved agent state, which
  is restored after;
- ``get_observation`` (environments.py:88-96): a render at any pose, the
  agent left where it was;
- ``oracle_distance``: the pathfinder's geodesic to the goal
  (environments.py:166-171).

Observations are host numpy (RGBA cut to RGB, depth over ``max_depth``
clipped to [0, 1]); ``EpisodeRunner`` uploads them, so the feed has no
device of its own.  habitat-sim is an optional host dependency: without it
the constructor raises and nothing else in the port is affected.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from dynam3d_torch.runtime.feed import STOP, Observation

try:  # optional host dependency
    import habitat_sim
except ImportError:  # pragma: no cover - present only on simulator hosts
    habitat_sim = None


def heading_to_quat(heading: float) -> np.ndarray:
    """Habitat rotation quaternion (x, y, z, w) of a ground-plane heading
    (radians counter-clockwise, 0 facing -z): environments.py:18-24."""
    half = heading / 2.0
    return np.asarray([0.0, math.sin(half), 0.0, math.cos(half)], np.float64)


def quat_to_heading(rotation) -> float:
    """Inverse of :func:`heading_to_quat` for a y-axis rotation
    (``arctan2(imag[1], real) * 2``, environments.py:132)."""
    y, w = float(rotation[1]), float(rotation[3])
    return (2.0 * math.atan2(y, w)) % (2.0 * math.pi)


class HabitatFeed:
    """One R2R-CE episode on a habitat-sim scene.

    ``episode``: ``start_position [3]``, ``start_rotation`` (x, y, z, w) or
    ``heading``, ``goals`` ([{"position": [3]}]) and ``instruction``
    ({"instruction_text": str} or str), the schema ``discrete_to_ce``
    writes.  Sensors: ``views`` RGB + depth cameras' worth of renders
    (336² RGB and 256² depth by default; 12 views for the waypoint
    panorama, view v at ``heading - v pi / 6``); MOVE_FORWARD moves
    ``forward_amount`` (0.25 m) and depth is normalized by ``max_depth``
    (10 m), the iter_train.yaml values."""

    def __init__(
        self,
        scene_id: str,
        episode: Dict,
        rgb_size: int = 336,
        depth_size: int = 256,
        views: int = 1,
        hfov_deg: float = 90.0,
        forward_amount: float = 0.25,
        max_depth: float = 10.0,
        agent_height: float = 1.25,
        agent_radius: float = 0.18,
    ):
        if habitat_sim is None:
            raise ImportError(
                "HabitatFeed needs habitat-sim (host-side; `pip install "
                "habitat-sim` on a simulator host) — without it use "
                "SyntheticRoomFeed / FloorplanFeed / RecordedEpisodeFeed"
            )
        self.views = views
        self.max_depth = max_depth
        self.forward = forward_amount
        self.episode = episode
        self.goal = np.asarray(episode["goals"][0]["position"], np.float32)
        instr = episode.get("instruction", "")
        self.instruction = instr["instruction_text"] if isinstance(instr, dict) else str(instr)

        sim_cfg = habitat_sim.SimulatorConfiguration()
        sim_cfg.scene_id = scene_id
        sim_cfg.allow_sliding = True  # the VLN-CE default

        def camera(uuid, kind, size):
            spec = habitat_sim.CameraSensorSpec()
            spec.uuid = uuid
            spec.sensor_type = kind
            spec.resolution = [size, size]
            spec.hfov = hfov_deg
            spec.position = [0.0, agent_height, 0.0]
            return spec

        agent_cfg = habitat_sim.agent.AgentConfiguration()
        agent_cfg.sensor_specifications = [
            camera("rgb", habitat_sim.SensorType.COLOR, rgb_size),
            camera("depth", habitat_sim.SensorType.DEPTH, depth_size),
        ]
        agent_cfg.radius = agent_radius
        agent_cfg.action_space = {
            "move_forward": habitat_sim.agent.ActionSpec(
                "move_forward", habitat_sim.agent.ActuationSpec(amount=forward_amount)),
        }
        self._sim = habitat_sim.Simulator(habitat_sim.Configuration(sim_cfg, [agent_cfg]))
        self._agent = self._sim.initialize_agent(0)

        self.positions: List[np.ndarray] = []
        self.headings: List[float] = []
        self.collisions = 0

    # --- agent state -------------------------------------------------------
    def _get_state(self):
        return self._agent.get_state()

    def _set_pose(self, position, heading: float) -> None:
        st = habitat_sim.AgentState()
        st.position = np.asarray(position, np.float32)
        st.rotation = heading_to_quat(heading)
        self._agent.set_state(st, reset_sensors=False)

    @property
    def _heading(self) -> float:
        rot = self._get_state().rotation
        quat = np.asarray([rot.x, rot.y, rot.z, rot.w]) if hasattr(rot, "w") else np.asarray(rot)
        return quat_to_heading(quat)

    def _render(self) -> Observation:
        st = self._get_state()
        heading = self._heading
        rgbs, depths = [], []
        for v in range(self.views):
            if v:
                # panorama view v at heading - v pi / 6 (observations_by_angles,
                # environments.py:98-113)
                self._set_pose(st.position, heading + v * (-math.pi / 6.0))
            obs = self._sim.get_sensor_observations()
            rgbs.append(np.asarray(obs["rgb"])[..., :3])
            d = np.asarray(obs["depth"], np.float32)
            depths.append(np.clip(d / self.max_depth, 0.0, 1.0))
        if self.views > 1:
            self._agent.set_state(st, reset_sensors=False)
        return Observation(
            rgb=np.stack(rgbs).astype(np.uint8),
            depth=np.stack(depths),
            position=np.asarray(st.position, np.float32),
            heading=heading,
            instruction=self.instruction,
        )

    # --- Feed protocol -------------------------------------------------------
    def reset(self) -> Observation:
        ep = self.episode
        if "start_rotation" in ep:
            x, y, z, w = ep["start_rotation"]
            heading = (2.0 * math.atan2(y, w)) % (2.0 * math.pi)
        else:
            heading = float(ep.get("heading", 0.0))
        self._set_pose(ep["start_position"], heading)
        self.positions = [np.asarray(ep["start_position"], np.float32)]
        self.headings = [heading]
        self.collisions = 0
        return self._render()

    def _forward_ksteps(self, distance: float) -> bool:
        """``int(distance // amount)`` MOVE_FORWARD steps
        (environments.py:136-138); whether any of them collided."""
        hit = False
        for _ in range(int(distance // self.forward)):
            before = np.asarray(self._get_state().position)
            self._sim.step({0: "move_forward"})
            after = np.asarray(self._get_state().position)
            hit = hit or float(np.linalg.norm(after - before)) < self.forward * 0.5
        return hit

    def step(self, action):
        if action == STOP:
            return self._render(), True, self._info()
        angle, distance = action
        heading = (self._heading + angle) % (2.0 * math.pi)
        self._set_pose(self._get_state().position, heading)
        self.collisions += int(self._forward_ksteps(distance))
        self.positions.append(np.asarray(self._get_state().position, np.float32))
        self.headings.append(heading)
        return self._render(), False, self._info()

    def oracle_distance(self, position: Optional[np.ndarray] = None) -> float:
        p = np.asarray(self._get_state().position if position is None else position)
        path = habitat_sim.ShortestPath()
        path.requested_start = p.astype(np.float32)
        path.requested_end = self.goal
        found = self._sim.pathfinder.find_path(path)
        return float(path.geodesic_distance) if found else 1e6

    def get_cand_real_pos(self, angle: float, forward: float) -> np.ndarray:
        saved = self._get_state()
        self._set_pose(saved.position, (self._heading + angle) % (2.0 * math.pi))
        self._forward_ksteps(forward)
        pos = np.asarray(self._get_state().position, np.float32)
        self._agent.set_state(saved, reset_sensors=False)
        return pos

    def cand_dist_to_goal(self, angle: float, forward: float) -> float:
        return self.oracle_distance(self.get_cand_real_pos(angle, forward))

    def get_observation(self, source_position, heading: float) -> Observation:
        saved = self._get_state()
        self._set_pose(np.asarray(source_position, np.float32), float(heading))
        obs = self._render()
        self._agent.set_state(saved, reset_sensors=False)
        return obs

    def _info(self) -> Dict:
        return {
            "position": [p.tolist() for p in self.positions],
            "heading": list(self.headings),
            "collisions": self.collisions,
            "distance_to_goal": self.oracle_distance(),
        }

    def close(self) -> None:
        self._sim.close()


def feeds_from_episode_file(path: str, scene_root: str, **feed_kwargs) -> List[HabitatFeed]:
    """One :class:`HabitatFeed` per episode of a CE episodes json[.gz] (the
    files ``discrete_to_ce`` writes and ``runtime.datasets`` loads)."""
    from dynam3d_torch.runtime.datasets import load_episodes

    return [
        HabitatFeed(
            scene_id=f"{scene_root}/{ep.scene_id}",
            episode={
                "start_position": ep.start_position,
                "start_rotation": ep.start_rotation,
                "goals": ep.goals,
                "instruction": ep.instruction_text,
            },
            **feed_kwargs,
        )
        for ep in load_episodes(path)
    ]
