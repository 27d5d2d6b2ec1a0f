"""VLN-CE episode datasets; own copy of ``runtime/datasets.py``
(``Episode``, ``load_episodes``, ``load_gt``, ``filter_episodes``,
``sample_two_scene_files``, ``episodes_by_scene``, ``write_episodes``).

The episode files are ``{split}.json[.gz]`` with an ``episodes`` list (the
R2R-CE / RxR-CE / REVERIE-CE / NavRAG-CE layout of the habitat dataset
registry, habitat_extensions/task.py:48-347) plus a ``{split}_gt.json[.gz]``
of gt locations and actions: no simulator is needed to parse, filter,
shard or write them.  ``sample_two_scene_files`` is the iterative trainer's
random two-scene draw (task.py:115-158).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import random
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class Episode:
    episode_id: str
    scene_id: str
    start_position: List[float]
    start_rotation: List[float]
    instruction_text: str
    reference_path: List[List[float]]
    goals: List[Dict]
    instruction_tokens: Optional[List[int]] = None
    trajectory_id: Optional[str] = None
    geodesic_distance: Optional[float] = None

    @classmethod
    def from_json(cls, d: Dict) -> "Episode":
        instr = d.get("instruction", {})
        return cls(
            episode_id=str(d["episode_id"]),
            scene_id=d.get("scene_id", ""),
            start_position=d.get("start_position", [0, 0, 0]),
            start_rotation=d.get("start_rotation", [0, 0, 0, 1]),
            instruction_text=instr.get("instruction_text", ""),
            instruction_tokens=instr.get("instruction_tokens"),
            reference_path=d.get("reference_path", []),
            goals=d.get("goals", []),
            trajectory_id=str(d.get("trajectory_id", d["episode_id"])),
            geodesic_distance=(d.get("info") or {}).get("geodesic_distance"),
        )


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def load_episodes(path: str) -> List[Episode]:
    """Parse a ``{split}.json[.gz]`` episode file."""
    with _open(path) as f:
        data = json.load(f)
    eps = data["episodes"] if isinstance(data, dict) else data
    return [Episode.from_json(e) for e in eps]


def load_gt(path: str) -> Dict[str, Dict]:
    """Parse ``{split}_gt.json[.gz]`` — per-episode gt locations/actions
    (collect_val_traj, base_il_trainer.py:732-772)."""
    with _open(path) as f:
        return {str(k): v for k, v in json.load(f).items()}


def filter_episodes(
    episodes: Sequence[Episode],
    allowed_ids: Optional[Sequence[str]] = None,
    scenes: Optional[Sequence[str]] = None,
) -> List[Episode]:
    """EPISODES_ALLOWED / scene filtering (task.py:96-112)."""
    out = list(episodes)
    if scenes is not None:
        sset = set(scenes)
        out = [e for e in out if _scene_name(e.scene_id) in sset]
    if allowed_ids is not None:
        aset = {str(i) for i in allowed_ids}
        out = [e for e in out if e.episode_id in aset]
    return out


def _scene_name(scene_id: str) -> str:
    return os.path.basename(scene_id).split(".")[0]


def sample_two_scene_files(scene_dir: str, rng: random.Random) -> List[str]:
    """The iterative trainer's random-2-scene sampling (task.py:115-133):
    choose the HM3D ("basis" in name) or MP3D pool with p=0.5, then 2 files
    with replacement."""
    files = [os.path.join(scene_dir, f) for f in os.listdir(scene_dir)]
    hm3d = [f for f in files if "basis" in f]
    mp3d = [f for f in files if "basis" not in f]
    pool = hm3d if (rng.choice([0, 1]) == 0 and hm3d) else (mp3d or hm3d)
    return [rng.choice(pool), rng.choice(pool)]


def episodes_by_scene(episodes: Sequence[Episode]) -> Dict[str, List[Episode]]:
    """Scene-split grouping (env_utils.construct_envs scene balancing)."""
    out: Dict[str, List[Episode]] = {}
    for e in episodes:
        out.setdefault(_scene_name(e.scene_id), []).append(e)
    return out


def write_episodes(path: str, episodes: Sequence[Episode]) -> None:
    payload = {
        "episodes": [
            {
                "episode_id": e.episode_id,
                "trajectory_id": e.trajectory_id,
                "scene_id": e.scene_id,
                "start_position": e.start_position,
                "start_rotation": e.start_rotation,
                "info": {"geodesic_distance": e.geodesic_distance},
                "goals": e.goals,
                "instruction": {
                    "instruction_text": e.instruction_text,
                    "instruction_tokens": e.instruction_tokens,
                },
                "reference_path": e.reference_path,
            }
            for e in episodes
        ]
    }
    opener = gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")
    with opener as f:
        json.dump(payload, f)
