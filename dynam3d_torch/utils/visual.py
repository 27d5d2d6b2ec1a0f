"""Visualization: top-down maps and navigation video frames; own copy of
``utils/visual.py``, the port of habitat_extensions/{maps,utils}.py's drawing surface
(``observations_to_image``, ``navigator_video_frame``, ``generate_video``)
without cv2/habitat deps: pure-numpy rasterization; video is written as an
.npz frame stack (or mp4 when an encoder is available on the host).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

AGENT_COLOR = (255, 64, 64)
PATH_COLOR = (64, 128, 255)
GT_COLOR = (64, 220, 64)
GOAL_COLOR = (255, 200, 0)
BG_COLOR = (240, 240, 240)
WALL_COLOR = (80, 80, 80)


class TopDownMap:
    """Rasterized top-down trajectory map (TopDownMapVLNCE equivalent)."""

    def __init__(
        self,
        bounds: Tuple[float, float, float, float],  # (xmin, xmax, zmin, zmax)
        resolution: int = 256,
    ):
        self.bounds = bounds
        self.res = resolution
        self.canvas = np.full((resolution, resolution, 3), BG_COLOR, np.uint8)

    def _to_px(self, xz: Sequence[float]) -> Tuple[int, int]:
        xmin, xmax, zmin, zmax = self.bounds
        u = int((xz[0] - xmin) / max(xmax - xmin, 1e-6) * (self.res - 1))
        v = int((xz[1] - zmin) / max(zmax - zmin, 1e-6) * (self.res - 1))
        return np.clip(v, 0, self.res - 1), np.clip(u, 0, self.res - 1)

    def _dot(self, xz, color, r=3):
        cy, cx = self._to_px(xz)
        y0, y1 = max(cy - r, 0), min(cy + r + 1, self.res)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, self.res)
        self.canvas[y0:y1, x0:x1] = color

    def _line(self, a, b, color):
        (y0, x0), (y1, x1) = self._to_px(a), self._to_px(b)
        n = max(abs(y1 - y0), abs(x1 - x0), 1)
        ys = np.linspace(y0, y1, n + 1).astype(int)
        xs = np.linspace(x0, x1, n + 1).astype(int)
        self.canvas[ys, xs] = color

    def draw_path(self, path_xz: Sequence[Sequence[float]], color=PATH_COLOR):
        for a, b in zip(path_xz[:-1], path_xz[1:]):
            self._line(a, b, color)

    def draw_goal(self, goal_xz, radius_m: float = 3.0):
        self._dot(goal_xz, GOAL_COLOR, r=4)

    def draw_agent(self, pos_xz, heading: float):
        self._dot(pos_xz, AGENT_COLOR, r=4)
        tip = (
            pos_xz[0] - 0.4 * np.sin(heading),
            pos_xz[1] - 0.4 * np.cos(heading),
        )
        self._line(pos_xz, tip, AGENT_COLOR)

    def image(self) -> np.ndarray:
        return self.canvas.copy()


def observations_to_image(
    rgb: np.ndarray, top_down: Optional[np.ndarray] = None
) -> np.ndarray:
    """Side-by-side RGB | map frame (habitat_extensions/utils.py surface)."""
    rgb = np.asarray(rgb, np.uint8)
    if top_down is None:
        return rgb
    h = rgb.shape[0]
    if top_down.shape[0] != h:
        ri = np.floor(np.arange(h) * (top_down.shape[0] / h)).astype(int)
        ci = np.floor(
            np.arange(int(top_down.shape[1] * h / top_down.shape[0]))
            * (top_down.shape[0] / h)
        ).astype(int)
        top_down = top_down[ri][:, np.clip(ci, 0, top_down.shape[1] - 1)]
    return np.concatenate([rgb, top_down], axis=1)


def navigator_video_frame(
    rgb: np.ndarray,
    pred_path: Sequence[Sequence[float]],
    gt_path: Optional[Sequence[Sequence[float]]],
    goal_xz: Optional[Sequence[float]],
    heading: float,
    bounds: Optional[Tuple[float, float, float, float]] = None,
) -> np.ndarray:
    """One annotated frame (navigator_video_frame, utils.py:647-752)."""
    pts = np.asarray(pred_path, np.float32)
    if bounds is None:
        allp = pts if gt_path is None else np.concatenate([pts, np.asarray(gt_path)])
        xmin, zmin = allp.min(0) - 1.0
        xmax, zmax = allp.max(0) + 1.0
        bounds = (float(xmin), float(xmax), float(zmin), float(zmax))
    m = TopDownMap(bounds)
    if gt_path is not None:
        m.draw_path(gt_path, GT_COLOR)
    m.draw_path(pred_path)
    if goal_xz is not None:
        m.draw_goal(goal_xz)
    m.draw_agent(pred_path[-1], heading)
    return observations_to_image(rgb, m.image())


def generate_video(
    frames: List[np.ndarray], out_path: str, fps: int = 5
) -> str:
    """Persist a frame stack (generate_video, utils.py:711).  Writes .npz
    always; .mp4 additionally when imageio/cv2 exist on the host."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    npz = out_path + ".npz"
    np.savez_compressed(npz, frames=np.stack(frames), fps=fps)
    try:  # optional encoders
        import imageio  # type: ignore

        imageio.mimwrite(out_path + ".mp4", frames, fps=fps)
    except Exception:
        pass
    return npz
