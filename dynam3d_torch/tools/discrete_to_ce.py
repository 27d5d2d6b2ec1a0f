"""Offline converter: discrete (MatterSim-graph) VLN datasets -> continuous
Habitat-style episodes.

    python -m dynam3d_torch.tools.discrete_to_ce --input ITEMS.json \
        --connectivity DIR --out EPISODES.json.gz --out-gt GT.json.gz \
        [--dataset navrag_train] [--cursor CURSOR.json]

Port of ``tools/discrete_to_ce.py``, itself the port of the
``discrete_to_CE`` package (REVERIE / NavRAG / ScaleVLN variants): each
discrete item carries a viewpoint path on a scene's connectivity graph; the
converter resolves viewpoint ids to metric positions, applies the
MatterSim->Habitat coordinate swap ``(x, y, z) -> (x, z, -y)``
(":294-296"), builds the start rotation from heading / elevation, filters
by geodesic distance and instruction quality (":320-330"), and writes
Habitat-CE ``episodes`` json + ``{split}_gt`` locations / actions records
(":331-355").

A ``connectivity/*.json`` graph directory gives viewpoint positions; the
geodesic distance is the graph's shortest path unless a simulator hook is
given (``geodesic_fn``, ``snap_fn``).  ``--cursor`` makes a batch
resumable, as the reference's per-scene worker restarts are.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_connectivity(conn_dir: str, scan_id: str) -> Dict[str, np.ndarray]:
    """MatterSim connectivity graph: viewpoint id -> habitat position.

    Files: ``{scan}_connectivity.json`` with per-node 4x4 pose matrices
    (standard MatterSim layout: position at indices [3, 7, 11]).
    """
    path = os.path.join(conn_dir, f"{scan_id}_connectivity.json")
    with open(path) as f:
        nodes = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for node in nodes:
        if not node.get("included", True):
            continue
        m = node["pose"]
        x, y, z = m[3], m[7], m[11]
        # MatterSim (x, y, z) -> habitat (x, z, -y)  (":294-296")
        out[node["image_id"]] = np.asarray([x, z, -y], np.float32)
    return out


def graph_edges(conn_dir: str, scan_id: str) -> Dict[str, List[str]]:
    path = os.path.join(conn_dir, f"{scan_id}_connectivity.json")
    with open(path) as f:
        nodes = json.load(f)
    ids = [n["image_id"] for n in nodes]
    out: Dict[str, List[str]] = {}
    for n in nodes:
        if not n.get("included", True):
            continue
        nbrs = [
            ids[j]
            for j, ok in enumerate(n.get("unobstructed", []))
            if ok and j < len(ids)
        ]
        out[n["image_id"]] = nbrs
    return out


def graph_geodesic(
    positions: Dict[str, np.ndarray],
    edges: Dict[str, List[str]],
    a: str,
    b: str,
) -> float:
    """Dijkstra over the nav graph (stand-in for habitat's navmesh geodesic)."""
    import heapq

    dist = {a: 0.0}
    heap = [(0.0, a)]
    while heap:
        d, u = heapq.heappop(heap)
        if u == b:
            return d
        if d > dist.get(u, math.inf):
            continue
        for v in edges.get(u, []):
            if v not in positions:
                continue
            nd = d + float(np.linalg.norm(positions[u] - positions[v]))
            if nd < dist.get(v, math.inf):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return math.inf


def heading_to_rotation(heading: float, elevation: float = 0.0) -> List[float]:
    """Habitat start rotation quaternion from MatterSim heading/elevation.

    ``R.from_rotvec([0, 2pi-h, 0]) * R.from_rotvec([e, 0, 0])`` (":298-303"),
    composed here without scipy.
    """
    hy = (2.0 * math.pi - heading) / 2.0
    ex = elevation / 2.0
    # quaternion (x,y,z,w) for rot-Y(2pi-h) then rot-X(e): q = qy * qx
    qy = (0.0, math.sin(hy), 0.0, math.cos(hy))
    qx = (math.sin(ex), 0.0, 0.0, math.cos(ex))

    def qmul(q1, q2):
        x1, y1, z1, w1 = q1
        x2, y2, z2, w2 = q2
        return [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]

    return qmul(qy, qx)


BANNED_WORDS = ("picture", "man", "person", "ceiling", "painting", "tight")


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset conversion rules, one entry per reference converter.

    The five reference scripts share one conversion core but differ in
    scene-id layout, camera-height handling, instruction expansion and
    filtering — the columns below:

    - ``scene_id_fmt``: MP3D ``mp3d/{scan}/{scan}.glb`` vs HM3D
      ``hm3d/train/{scan}/{scan_tail}.basis.glb``.
    - ``height_offset``: MP3D converters subtract the 1.25 m camera height
      (``[x, z-1.25, -y]``, discrete_to_CE_reverie_train.py:292); HM3D
      converters keep the raw height (navrag_train:303).
    - ``all_instructions``: REVERIE/NavRAG-val expand one episode per
      instruction (reverie_train:313); the HM3D train sets take only the
      first (navrag_train:341).
    - ``quality_filter``: NavRAG-train additionally drops items over
      25 words, geodesic > 15 m, banned words, and caps 2000 items/scene
      after a shuffle (navrag_train:324).
    - ``episode_id_base``: 50000 REVERIE / 100000 ScaleVLN / 500000 NavRAG
      so merged training corpora keep disjoint id ranges.
    - ``per_scene_output``: train sets shard episodes into one json per
      scene (reverie_train:375-383); val sets write a single file.
    """

    scene_id_fmt: str
    height_offset: float = 0.0
    all_instructions: bool = True
    quality_filter: bool = False
    require_hm3d: bool = False
    scene_cap: Optional[int] = None
    shuffle_per_scene: bool = False
    episode_id_base: int = 0
    per_scene_output: bool = False
    max_instr_words: int = 25
    max_geodesic: float = 15.0


MP3D_FMT = "mp3d/{scan}/{scan}.glb"
HM3D_FMT = "hm3d/train/{scan}/{scan_tail}.basis.glb"

DATASETS: Dict[str, DatasetSpec] = {
    # discrete_to_CE_reverie_train.py
    "reverie_train": DatasetSpec(
        MP3D_FMT, height_offset=-1.25, all_instructions=True,
        episode_id_base=50000, per_scene_output=True,
    ),
    # discrete_to_CE_reverie_val_test.py
    "reverie_val": DatasetSpec(
        MP3D_FMT, height_offset=-1.25, all_instructions=True,
    ),
    # discrete_to_CE_navrag_train.py (HM3D only; shuffled, capped, filtered)
    "navrag_train": DatasetSpec(
        HM3D_FMT, all_instructions=False, quality_filter=True,
        require_hm3d=True, scene_cap=2000, shuffle_per_scene=True,
        episode_id_base=500000, per_scene_output=True,
    ),
    # discrete_to_CE_navrag_val.py (MP3D val split)
    "navrag_val": DatasetSpec(
        MP3D_FMT, height_offset=-1.25, all_instructions=True,
    ),
    # discrete_to_CE_scalevln_train.py
    "scalevln_train": DatasetSpec(
        HM3D_FMT, all_instructions=False,
        episode_id_base=100000, per_scene_output=True,
    ),
}


def convert_items(
    items: Sequence[Dict],
    conn_dir: str,
    spec: DatasetSpec = DATASETS["navrag_train"],
    geodesic_fn: Optional[Callable[[str, str, str], float]] = None,
    snap_fn: Optional[Callable[[str, List[float]], List[float]]] = None,
    start_episode_id: Optional[int] = None,
    rng_seed: int = 0,
) -> Tuple[List[Dict], Dict[str, Dict]]:
    """Convert discrete items -> (CE episodes, gt records) under ``spec``.

    ``items``: dicts with ``scan``, ``path`` (viewpoint ids), ``heading``,
    ``instructions`` (+ optional ``instr_encodings``) — the NavRAG/REVERIE/
    ScaleVLN schema.  gt records use the ``forward_steps = 6 * len(path)``
    convention (navrag_train:346-350).

    ``geodesic_fn(scan, vp_a, vp_b)`` and ``snap_fn(scan, position)`` plug a
    real simulator in on hosts that have one: the reference converters use
    ``habitat_sim.geodesic_distance`` / navmesh snapping; the defaults here
    are graph geodesics with raw graph positions (exact on the nav graph).
    """
    episodes: List[Dict] = []
    gts: Dict[str, Dict] = {}
    episode_id = (
        spec.episode_id_base if start_episode_id is None else start_episode_id
    )
    cache: Dict[str, Tuple[Dict, Dict]] = {}
    per_scene_count: Dict[str, int] = {}

    if spec.shuffle_per_scene:
        # navrag_train:291 shuffles each scene's items before the cap so the
        # 2000 kept are a random sample, not a prefix
        by_scene: Dict[str, List[Dict]] = {}
        for it in items:
            by_scene.setdefault(it["scan"], []).append(it)
        rng = np.random.default_rng(rng_seed)
        items = []
        for scan in by_scene:
            idx = rng.permutation(len(by_scene[scan]))
            items.extend(by_scene[scan][i] for i in idx)

    for item in items:
        scan = item["scan"]
        if spec.require_hm3d and "-" not in scan:
            continue  # navrag_train:295 skips MP3D scans
        if spec.scene_cap and per_scene_count.get(scan, 0) >= spec.scene_cap:
            continue
        if scan not in cache:
            try:
                cache[scan] = (
                    load_connectivity(conn_dir, scan),
                    graph_edges(conn_dir, scan),
                )
            except FileNotFoundError:
                continue
        positions, edges = cache[scan]
        path_ids = item["path"]
        if any(v not in positions for v in path_ids):
            continue
        ref_path = [
            [float(p[0]), float(p[1]) + spec.height_offset, float(p[2])]
            for p in (positions[v] for v in path_ids)
        ]
        if snap_fn is not None:
            ref_path = [list(snap_fn(scan, p)) for p in ref_path]

        if geodesic_fn is not None:
            geo = geodesic_fn(scan, path_ids[0], path_ids[-1])
        else:
            geo = graph_geodesic(positions, edges, path_ids[0], path_ids[-1])
        if not math.isfinite(geo) or geo >= 100.0:
            continue  # the shared navigability filter (all converters)
        instr0 = item["instructions"][0]
        if spec.quality_filter and (
            geo > spec.max_geodesic
            or len(instr0.split(" ")) > spec.max_instr_words
            or any(w in instr0 for w in BANNED_WORDS)
        ):
            continue

        n_instr = len(item["instructions"]) if spec.all_instructions else 1
        for ii in range(n_instr):
            episode_id += 1
            per_scene_count[scan] = per_scene_count.get(scan, 0) + 1
            scan_tail = scan[6:] if len(scan) > 6 else scan
            episodes.append(
                {
                    "episode_id": episode_id,
                    "trajectory_id": episode_id,
                    "scene_id": spec.scene_id_fmt.format(
                        scan=scan, scan_tail=scan_tail
                    ),
                    "start_position": ref_path[0],
                    "start_rotation": heading_to_rotation(
                        item.get("heading", 0.0)
                    ),
                    "info": {"geodesic_distance": geo},
                    "goals": [{"position": ref_path[-1], "radius": 3.0}],
                    "instruction": {
                        "instruction_text": item["instructions"][ii],
                        "instruction_tokens": (
                            item.get("instr_encodings") or [None] * n_instr
                        )[ii],
                    },
                    "reference_path": ref_path,
                }
            )
            gts[str(episode_id)] = {
                "locations": ref_path,
                "forward_steps": len(ref_path) * 6,
                "actions": [1] * (len(ref_path) * 6),
            }
    return episodes, gts


def write_outputs(
    episodes: List[Dict], gts: Dict[str, Dict], out: str, out_gt: str,
    per_scene: bool = False,
) -> None:
    """Write episodes + gt; train specs shard one json per scene
    (reverie_train:375-383), val specs write a single episodes file."""
    opener = gzip.open if out.endswith(".gz") else open
    if per_scene:
        os.makedirs(out, exist_ok=True)
        by_scene: Dict[str, List[Dict]] = {}
        for ep in episodes:
            by_scene.setdefault(ep["scene_id"].split("/")[-1], []).append(ep)
        for scene_file, eps in by_scene.items():
            with open(os.path.join(out, scene_file + ".json"), "w") as f:
                json.dump(eps, f)
    else:
        with opener(out, "wt") as f:
            json.dump({"episodes": episodes}, f)
    gt_opener = gzip.open if out_gt.endswith(".gz") else open
    with gt_opener(out_gt, "wt") as f:
        json.dump(gts, f)


def main(argv=None):
    p = argparse.ArgumentParser(description="discrete VLN -> Habitat-CE episodes")
    p.add_argument("--input", required=True, help="discrete dataset json")
    p.add_argument("--connectivity", required=True, help="connectivity dir")
    p.add_argument("--dataset", default="navrag_train",
                   choices=sorted(DATASETS), help="which reference converter")
    p.add_argument("--out", required=True,
                   help="episodes json[.gz], or a directory for train sets")
    p.add_argument("--out-gt", required=True, help="output gt json[.gz]")
    p.add_argument("--cursor", default=None,
                   help="resume cursor file (batch-restart protocol)")
    args = p.parse_args(argv)

    spec = DATASETS[args.dataset]
    with open(args.input) as f:
        items = json.load(f)
    start = 0
    if args.cursor and os.path.exists(args.cursor):
        with open(args.cursor) as f:
            start = json.load(f)["item_id"]
    episodes, gts = convert_items(items[start:], args.connectivity, spec)
    write_outputs(episodes, gts, args.out, args.out_gt, spec.per_scene_output)
    if args.cursor:
        with open(args.cursor, "w") as f:
            json.dump({"item_id": len(items)}, f)


if __name__ == "__main__":
    main()
