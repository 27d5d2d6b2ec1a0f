"""The reference's view of a configuration file: the ``model`` object as
nested attribute namespaces, with the two sizes derived from it (the CLIP
grid and the segmenter's block depths).  Reads nothing but the file."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict


def _ns(node: Any) -> Any:
    if isinstance(node, dict):
        return SimpleNamespace(**{k: _ns(v) for k, v in node.items()})
    return node


def from_dict(model: Dict) -> SimpleNamespace:
    cfg = _ns(model)
    cfg.clip.grid = cfg.clip.image_size // cfg.clip.patch_size
    seg = cfg.segmenter
    # ultralytics depth scaling of YOLOv8's (3, 6, 6, 3) C2f repeats, at least 1
    seg.depth_n = tuple(max(1, round(n * seg.depth_mult)) for n in (3, 6, 6, 3))
    return cfg
