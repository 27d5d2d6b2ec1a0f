"""Common utilities; own copy of ``utils/misc.py`` (vlnce_baselines
common/utils.py and models/utils.py):

  - the per-character instruction codec (``ord`` packing,
    common/utils.py:8-31, decoded with ``chr`` as ss_trainer_Dynam3D.py:615
    does);
  - the discrete -> continuous path densifier (common/utils.py:46-61);
  - the 12-camera panorama orientations (common/utils.py:63-69);
  - angle features (models/utils.py:49-57) and ``length2mask`` (":77-81").

The cross-rank ``gather_list_and_concat`` belongs with the parallel
runtime and is not here.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def encode_instruction(text: str, max_length: int = 200, pad_id: int = 0) -> np.ndarray:
    """Per-character ord() packing (common/utils.py:24-27)."""
    ids = [ord(c) for c in text[:max_length]]
    out = np.full((max_length,), pad_id, np.int64)
    out[: len(ids)] = ids
    return out


def decode_instruction(tokens: Sequence[int], pad_id: int = 0) -> str:
    """chr() unpacking (ss_trainer_Dynam3D.py:615)."""
    return "".join(chr(int(t)) for t in tokens if int(t) != pad_id)


def densify_path(path: np.ndarray, step: float = 0.25) -> np.ndarray:
    """Discrete->continuous waypoint densifier (common/utils.py:46-61):
    linearly interpolate so consecutive points are <= ``step`` apart."""
    path = np.asarray(path, np.float32)
    out: List[np.ndarray] = [path[0]]
    for nxt in path[1:]:
        prev = out[-1]
        d = float(np.linalg.norm(nxt - prev))
        n = max(int(math.ceil(d / step)), 1)
        for i in range(1, n + 1):
            out.append(prev + (nxt - prev) * (i / n))
    return np.stack(out)


def camera_orientations(num: int = 12) -> List[List[float]]:
    """12 panorama camera orientations, -30 deg increments about y
    (common/utils.py:63-69)."""
    base = 2 * math.pi / num
    return [[0.0, -i * base, 0.0] for i in range(num)]


def angle_feature(headings: Sequence[float]) -> np.ndarray:
    """[sin h, cos h, sin 0, cos 0] features (models/utils.py:49-57)."""
    h = np.asarray(headings, np.float32)
    z = np.zeros_like(h)
    return np.stack([np.sin(h), np.cos(h), np.sin(z), np.cos(z)], axis=-1)


def length2mask(lengths: Sequence[int], size: int | None = None) -> np.ndarray:
    """True where PADDED (models/utils.py:77-81)."""
    lengths = np.asarray(lengths, np.int64)
    size = int(lengths.max()) if size is None else size
    return np.arange(size)[None, :] > (lengths - 1)[:, None]
