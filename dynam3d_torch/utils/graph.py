"""Topological graph utilities; own copy of ``utils/graph.py``.

``FloydGraph`` (incremental all-pairs shortest paths,
vlnce_baselines/models/graph_utils.py:74-130) and ``GraphMap`` (visited
nodes plus ghost candidate nodes, with shortest paths through
``FloydGraph``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


class FloydGraph:
    """Incremental Floyd-Warshall over named nodes."""

    def __init__(self):
        self._dis: Dict[str, Dict[str, float]] = {}
        self._point: Dict[str, Dict[str, str]] = {}
        self._visited: set = set()

    def distance(self, x: str, y: str) -> float:
        if x == y:
            return 0.0
        return self._dis.get(x, {}).get(y, math.inf)

    def add_edge(self, x: str, y: str, dis: float) -> None:
        for n in (x, y):
            self._dis.setdefault(n, {})
            self._point.setdefault(n, {})
        if dis < self.distance(x, y):
            self._dis[x][y] = dis
            self._dis[y][x] = dis
            self._point[x][y] = ""
            self._point[y][x] = ""

    def update(self, k: str) -> None:
        """Relax all pairs through newly visited node k."""
        nodes = list(self._dis.keys())
        for x in nodes:
            for y in nodes:
                if x != y and k not in (x, y):
                    through = self.distance(x, k) + self.distance(k, y)
                    if through < self.distance(x, y):
                        self._dis[x][y] = through
                        self._dis[y][x] = through
                        self._point[x][y] = k
                        self._point[y][x] = k
        self._visited.add(k)

    def visited(self, k: str) -> bool:
        return k in self._visited

    def path(self, x: str, y: str) -> List[str]:
        if x == y:
            return []
        k = self._point.get(x, {}).get(y, None)
        if k is None:
            return [y]
        if k == "":
            return [y]
        return self.path(x, k) + self.path(k, y)


class GraphMap:
    """Topological memory: visited nodes + frontier ("ghost") candidates.

    Minimal port of graph_utils.GraphMap — node registry with positions,
    ghost-node bookkeeping, and shortest-path queries via FloydGraph.
    """

    def __init__(self, start_pos: np.ndarray):
        self.graph = FloydGraph()
        self.node_pos: Dict[str, np.ndarray] = {}
        self.ghost_pos: Dict[str, np.ndarray] = {}
        self.ghost_front: Dict[str, Tuple[str, float]] = {}
        self._node_counter = 0
        self._ghost_counter = 0
        self.start_id = self.add_node(np.asarray(start_pos, np.float32))

    def add_node(self, pos: np.ndarray, connect_to: Optional[str] = None) -> str:
        nid = str(self._node_counter)
        self._node_counter += 1
        self.node_pos[nid] = np.asarray(pos, np.float32)
        if connect_to is not None:
            d = float(np.linalg.norm(self.node_pos[connect_to] - pos))
            self.graph.add_edge(connect_to, nid, d)
        self.graph.update(nid)
        return nid

    def add_ghost(self, pos: np.ndarray, front_node: str) -> str:
        gid = f"g{self._ghost_counter}"
        self._ghost_counter += 1
        self.ghost_pos[gid] = np.asarray(pos, np.float32)
        d = float(np.linalg.norm(self.node_pos[front_node] - pos))
        self.ghost_front[gid] = (front_node, d)
        return gid

    def delete_ghost(self, gid: str) -> None:
        self.ghost_pos.pop(gid, None)
        self.ghost_front.pop(gid, None)

    def shortest_path(self, a: str, b: str) -> Tuple[float, List[str]]:
        """Shortest path between nodes; ghosts route via their front node
        (the reference reaches ghosts only through frontier nodes)."""
        if b in self.ghost_front:
            front, d = self.ghost_front[b]
            base, path = self.shortest_path(a, front)
            return base + d, path + [b]
        return self.graph.distance(a, b), self.graph.path(a, b)

    def localize(self, pos: np.ndarray, max_dist: float = 0.5) -> Optional[str]:
        """Nearest visited node within ``max_dist``."""
        best, best_d = None, max_dist
        for nid, p in self.node_pos.items():
            d = float(np.linalg.norm(p - np.asarray(pos, np.float32)))
            if d <= best_d:
                best, best_d = nid, d
        return best
