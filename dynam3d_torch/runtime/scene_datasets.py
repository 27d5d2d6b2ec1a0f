"""Posed-frame scene datasets for 3DFF pretraining; port of
``runtime/scene_datasets.py``.

The reference trainer preloads four posed-RGB-D corpora plus the SceneVerse
annotation index (``src_3dff/ss_trainer_3DFF.py:70-211``) and draws random
frames per iteration from each dataset's own on-disk layout:

  - ScanNet     ``<scene>/color/<id>.jpg`` + ``depth/<id>.png`` (uint16 mm) +
                ``pose/<id>.txt`` (4x4 cam-to-world) + ``intrinsic_depth.txt``
                with fx/fy/cx/cy halved for the reduced resolution
                (``:1189-1236``).
  - 3RScan      ``<scene>/sequence/frame-XXXXXX.{color.jpg,depth.pgm,pose.txt}``
                + intrinsics from line 9 of ``_info.txt`` (``:1502-1551``).
  - ARKitScenes ``lowres_wide/*.png`` + ``lowres_depth/*.png`` + per-frame
                ``lowres_wide_intrinsics/*.pincam`` + ``lowres_wide.traj``
                (axis-angle world-to-cam rows; ``:1818-1860,701-733``).
  - Structured3D ``scene_XXXXX/2D_rendering/<room>/perspective/full/<view>/``
                with ``camera_pose.txt`` (lookat/up/fov rows), ``rgb_rawlight
                .png``, ``depth.png`` (``:2125-2160,664-688``).

All depths are stored millimetre-scaled (``depth_scale=1000.`` at every
``update_feature_fields`` call site, e.g. ``:1267``).  SceneVerse supplies the
language supervision: per-scene pcd ``.pth`` tuples (xyz at index 0; instance
labels at index 3 for ScanNet, -1 for 3RScan/ARKit, 2 for HM3D/Structured3D —
``:1174,1485,2103``), ``instance_id_to_label`` dicts, caption JSONs keyed
``annotations[scene_id][str(instance_id)] -> [(category, text), ...]``
(``:1313-1343``) and normalized ``category_embeddings.pth`` (``:70-73``).

Each loader also derives a habitat-style ``(position, heading)`` pose from
the camera-to-world ``(R, T)``: the ground-plane heading of the camera
forward axis, as the reference's extrinsic-mode heading trick does
(``src_3dff/models/feature_fields.py:505-514``).  The full ``(K, R, T,
world2cam)`` set stays in the sample, and ``PretrainRunner.build_batch``
takes the posed path on it.

Everything here is host-side numpy, in float64 where the cameras are
parsed; ``torch.load`` reads the SceneVerse ``.pth`` blobs.  Frame order
comes from ``random.Random(seed)`` as in the reference, so both packages
draw the same frames.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "axis_angle_to_matrix",
    "traj_line_to_extrinsic",
    "pincam_intrinsics",
    "parse_structured3d_camera",
    "load_matrix_txt",
    "scannet_depth_intrinsics",
    "rscan_intrinsics_from_info",
    "pose_from_extrinsic",
    "world_to_habitat",
    "load_category_embeddings",
    "load_sceneverse_pcd",
    "load_instance_labels",
    "SceneVerseAnnotations",
    "HM3DSemanticIndex",
    "ScanNetScenes",
    "RScanScenes",
    "ARKitScenes",
    "Structured3DScenes",
    "build_language_supervision",
]


# ---------------------------------------------------------------------------
# camera parameter parsing
# ---------------------------------------------------------------------------
def load_matrix_txt(path: str, n: int = 4) -> np.ndarray:
    """Whitespace-delimited ``n x n`` matrix file (ScanNet/3RScan pose &
    intrinsic format, ``ss_trainer_3DFF.py:1210-1231``)."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    m = np.eye(n, dtype=np.float64)
    for i in range(n):
        for j in range(n):
            m[i, j] = float(rows[i][j])
    return m


def scannet_depth_intrinsics(path: str) -> np.ndarray:
    """ScanNet ``intrinsic_depth.txt`` with the frames_square halving
    (``:1216-1220``: fx, fy, cx, cy all / 2)."""
    k = load_matrix_txt(path, 4)
    k[0, 0] /= 2.0
    k[1, 1] /= 2.0
    k[0, 2] /= 2.0
    k[1, 2] /= 2.0
    return k


def rscan_intrinsics_from_info(path: str) -> np.ndarray:
    """3RScan ``_info.txt``: 16 floats on line index 9 after two header
    tokens (``:1527-1533``)."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    vals = lines[9].split(" ")[2:]
    k = np.eye(4, dtype=np.float64)
    for i in range(4):
        for j in range(4):
            k[i, j] = float(vals[i * 4 + j])
    return k


def pincam_intrinsics(path: str) -> np.ndarray:
    """ARKitScenes ``.pincam`` -> 3x3 K (``st2_camera_intrinsics``,
    ``:728-730``)."""
    w, h, fx, fy, hw, hh = np.loadtxt(path)
    return np.asarray([[fx, 0, hw], [0, fy, hh], [0, 0, 1]], np.float64)


def axis_angle_to_matrix(v: np.ndarray) -> np.ndarray:
    """Rodrigues rotation (drop-in for ``cv2.Rodrigues``; the reference uses
    cv2 only for this conversion, ``:692-698``)."""
    v = np.asarray(v, np.float64).reshape(3)
    theta = float(np.linalg.norm(v))
    if theta < 1e-12:
        return np.eye(3)
    k = v / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], np.float64
    )
    return np.eye(3) + math.sin(theta) * kx + (1 - math.cos(theta)) * (kx @ kx)


def traj_line_to_extrinsic(line: str) -> np.ndarray:
    """One ``lowres_wide.traj`` row -> 4x4 camera-to-world matrix.

    The row stores world-to-camera axis-angle + translation; the reference
    inverts it (``TrajStringToMatrix``, ``:701-726``).
    """
    tok = line.split()
    assert len(tok) == 7, f"traj row must have 7 columns, got {len(tok)}"
    r_w2c = axis_angle_to_matrix(np.float64(tok[1:4]))
    ext = np.eye(4)
    ext[:3, :3] = r_w2c
    ext[:3, 3] = np.float64(tok[4:7])
    return np.linalg.inv(ext)


def parse_structured3d_camera(
    camera_info: np.ndarray, height: int, width: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured3D ``camera_pose.txt`` row -> (rot[3,3], trans[3], K[3,3]).

    Matches ``parse_camera_info`` (``:664-688``): rows of the rotation are the
    camera right/down/forward axes from the lookat/up vectors; translation is
    millimetres -> metres; K from the half-angle fovs.
    """
    camera_info = np.asarray(camera_info, np.float64)
    lookat = camera_info[3:6] / np.linalg.norm(camera_info[3:6])
    up = camera_info[6:9] / np.linalg.norm(camera_info[6:9])
    w_axis = lookat
    u_axis = np.cross(w_axis, up)
    v_axis = np.cross(w_axis, u_axis)
    rot = np.vstack((u_axis, v_axis, w_axis))
    trans = camera_info[:3] / 1000.0
    k = np.eye(3)
    k[0, 2] = width / 2.0
    k[1, 2] = height / 2.0
    k[0, 0] = k[0, 2] / math.tan(camera_info[9])
    k[1, 1] = k[1, 2] / math.tan(camera_info[10])
    return rot, trans, k


# ---------------------------------------------------------------------------
# pose derivation for the habitat-mode device kernel
# ---------------------------------------------------------------------------
def _heading_from_displacement(dx: float, dy: float) -> float:
    """Host twin of geom.projection.heading_from_positions (one vector)."""
    dist = max(math.sqrt(dx * dx + dy * dy), 1e-4)
    heading = -math.asin(dx / dist)
    if dy < 0:
        heading -= math.pi
    return heading


def pose_from_extrinsic(
    rot: np.ndarray, trans: np.ndarray
) -> Tuple[np.ndarray, float]:
    """Camera-to-world (R, T) -> (world position [3], ground-plane heading).

    The camera forward axis (+z in camera frame) pushed through the FULL
    (R, T) gives the reference's camera direction: ``get_heading_angle(
    R @ [0,0,1] + T)`` (``src_3dff/models/feature_fields.py:505-514``) — the
    translation is deliberately part of the angle.  Stored patch directions
    use the same T-polluted convention (get_heading_angle of world points,
    ":915"), so the render-time relative direction ``patch_dir - heading``
    subtracts consistently, as the two quirks cancel in the reference.
    """
    rot = np.asarray(rot, np.float64)
    fwd = rot @ np.asarray([0.0, 0.0, 1.0]) + np.asarray(trans, np.float64).reshape(3)
    heading = _heading_from_displacement(float(fwd[0]), float(fwd[1]))
    return np.asarray(trans, np.float32).reshape(3), float(heading)


def world_to_habitat(p: np.ndarray) -> np.ndarray:
    """Inverse of geom.projection.habitat_to_world: world (x, y, z) ->
    habitat (x, z, -y), so loader poses survive the runner's own
    habitat->world conversion round trip."""
    p = np.asarray(p, np.float32)
    return np.stack([p[..., 0], p[..., 2], -p[..., 1]], axis=-1)


# ---------------------------------------------------------------------------
# SceneVerse supervision blobs
# ---------------------------------------------------------------------------
def load_category_embeddings(path: str) -> Tuple[Dict[str, int], np.ndarray]:
    """``category_embeddings.pth`` -> (category -> row dict, L2-normalized
    embedding matrix) (``:70-73``)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    cat_dict, emb = data[0], data[1]
    emb = np.asarray(emb.float().numpy())
    emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
    return dict(cat_dict), emb.astype(np.float32)


def load_sceneverse_pcd(
    paths: Sequence[str],
    label_index: int,
    align_matrix: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate SceneVerse ``pcd_with_global_alignment`` tuples.

    ``label_index`` is per-dataset (3 for ScanNet ``:1174``; -1 for
    3RScan/ARKit ``:1485,1801``; 2 for Structured3D ``:2103``).  ScanNet
    additionally aligns xyz with the inverse align matrix (``:1169-1173``).
    """
    xyzs, labels = [], []
    for path in paths:
        blob = torch.load(path, map_location="cpu", weights_only=False)
        xyz = np.asarray(blob[0], np.float32)
        if align_matrix is not None:
            hom = np.ones((xyz.shape[0], 4), np.float32)
            hom[:, :3] = xyz
            xyz = (hom @ np.linalg.inv(align_matrix).T.astype(np.float32))[:, :3]
        xyzs.append(xyz)
        labels.append(np.asarray(blob[label_index]).astype(np.int32).reshape(-1))
    return np.concatenate(xyzs, 0), np.concatenate(labels, 0)


def load_instance_labels(paths: Sequence[str]) -> Dict[int, str]:
    """Union of ``instance_id_to_label`` dicts (``:1179-1184``)."""
    out: Dict[int, str] = {}
    for path in paths:
        out.update(torch.load(path, map_location="cpu", weights_only=False))
    return out


class SceneVerseAnnotations:
    """``3dff_<dataset>_annotations.json``:
    ``scene_id -> {instance_id: [(category, caption), ...]}``."""

    def __init__(self, path: str):
        with open(path) as f:
            self._ann = json.load(f)

    def scenes(self) -> List[str]:
        return list(self._ann.keys())

    def __contains__(self, scene_id: str) -> bool:
        return scene_id in self._ann

    def sample_caption(
        self, scene_id: str, instance_id: int, rng: random.Random
    ) -> Optional[Tuple[str, str]]:
        """Random (category, caption) for an instance, or None
        (``random.choice`` at ``:1323,1343``)."""
        per_scene = self._ann.get(scene_id)
        if not per_scene:
            return None
        entries = per_scene.get(str(instance_id))
        if not entries:
            return None
        cat, text = rng.choice(entries)
        return cat, text


# ---------------------------------------------------------------------------
# frame-sampling base
# ---------------------------------------------------------------------------
def _fill_to(items: List, n: int) -> List:
    """Pad a shuffled frame list to n by repetition (``:1196-1197``)."""
    if not items:
        raise ValueError("no frames found")
    while len(items) < n:
        items = items + items[: n - len(items)]
    return items[:n]


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def _load_depth_mm(path: str, far_m: float = 10.0) -> np.ndarray:
    """uint16 millimetre depth image -> normalized [0, 1] over ``far_m``.

    Matches the reference's ``depth_scale=1000.`` (``:1267``) and its
    zero-pixel noise filter ``depth[depth==0] = depth.max()`` applied before
    unprojection (``project_depth_to_3d``, feature_fields.py:79).

    INTENTIONAL DIVERGENCE: the reference truncates at ``depth_trunc=1000`` m
    while this pipeline's kernels consume [0,1]-normalized depth over a 10 m
    far plane (FieldsConfig.depth_far); indoor sensor depth beyond 10 m is
    clipped to the plane instead of kept metric.  For the indoor corpora this
    pipeline targets (ScanNet/3RScan/ARKit/Structured3D) real returns are
    well under 10 m, so only already-noisy far pixels are affected.
    """
    from PIL import Image

    raw = np.asarray(Image.open(path), np.float32)
    raw = np.where(raw == 0, raw.max(), raw)
    return np.clip(raw / 1000.0 / far_m, 0.0, 1.0)


class _PosedFrameScenes:
    """Shared sample_scene(): N random frames + derived habitat-mode poses +
    gt pcd/labels; subclasses provide frame discovery and parsing."""

    label_index: int = -1

    def __init__(
        self,
        root: str,
        annotations: Optional[SceneVerseAnnotations] = None,
        frames: int = 16,
        seed: int = 0,
        use_labels: bool = True,
    ):
        self.root = root
        self.annotations = annotations
        self.frames = frames
        self.rng = random.Random(seed)
        self.use_labels = use_labels
        self.scene_ids = self._discover()
        if annotations is not None:
            keep = [s for s in self.scene_ids if s in annotations]
            self.scene_ids = keep or self.scene_ids

    # subclass hooks ----------------------------------------------------
    def _discover(self) -> List[str]:
        raise NotImplementedError

    def _frame_ids(self, scene_id: str) -> List[str]:
        raise NotImplementedError

    def _load_frame(self, scene_id: str, frame_id: str):
        """-> (rgb u8 [H,W,3], depth_norm [Hd,Wd], K 3x3/4x4, R 3x3, T [3])"""
        raise NotImplementedError

    def _gt_pcd(self, scene_id: str) -> Tuple[np.ndarray, np.ndarray]:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)

    # ---------------------------------------------------------------
    def sample_scene(self) -> Dict:
        scene_id = self.rng.choice(self.scene_ids)
        ids = self._frame_ids(scene_id)
        self.rng.shuffle(ids)
        # over-draw: frames with invalid cameras (ScanNet writes -inf poses
        # for tracking-lost frames; ARKit may miss a pincam) are skipped
        candidates = _fill_to(ids, self.frames) + ids

        rgbs, depths, ks, rots, transs, exts, poss, hds = (
            [], [], [], [], [], [], [], [],
        )
        for fid in candidates:
            if len(rgbs) == self.frames:
                break
            try:
                rgb, depth, k, rot, trans = self._load_frame(scene_id, fid)
            except (FileNotFoundError, KeyError):
                continue
            ext = np.eye(4)
            ext[:3, :3] = rot
            ext[:3, 3] = trans
            if not (np.isfinite(ext).all() and np.isfinite(np.asarray(k)).all()):
                continue
            pos, hd = pose_from_extrinsic(rot, trans)
            rgbs.append(rgb)
            depths.append(depth)
            ks.append(np.asarray(k, np.float32))
            rots.append(np.asarray(rot, np.float32))
            transs.append(np.asarray(trans, np.float32).reshape(3))
            exts.append(np.linalg.inv(ext).astype(np.float32))
            poss.append(world_to_habitat(pos))
            hds.append(hd)
        if not rgbs:
            raise ValueError(f"no valid frames in scene {scene_id}")
        n0 = len(rgbs)
        while len(rgbs) < self.frames:  # repeat-fill like _fill_to (":1196")
            i = len(rgbs) % n0
            for lst in (rgbs, depths, ks, rots, transs, exts, poss, hds):
                lst.append(lst[i])

        gt_xyz, gt_label = self._gt_pcd(scene_id)
        return dict(
            scene_id=scene_id,
            rgb=np.stack(rgbs),
            depth=np.stack(depths),
            position=np.stack(poss).astype(np.float32),
            heading=np.asarray(hds, np.float32),
            intrinsics=np.stack(ks),
            rot=np.stack(rots),
            trans=np.stack(transs),
            world2cam=np.stack(exts),
            gt_xyz=gt_xyz,
            gt_label=gt_label,
            use_labels=self.use_labels and gt_xyz.shape[0] > 0,
        )


# ---------------------------------------------------------------------------
# the four dataset layouts
# ---------------------------------------------------------------------------
class ScanNetScenes(_PosedFrameScenes):
    """``frames_square`` ScanNet layout (``:1189-1236``); pcd label index 3;
    align-matrix applied to SceneVerse xyz."""

    label_index = 3

    def __init__(
        self,
        root: str,
        sceneverse_root: Optional[str] = None,
        align_matrix_json: Optional[str] = None,
        **kw,
    ):
        self.sceneverse_root = sceneverse_root
        self.align = {}
        if align_matrix_json and os.path.exists(align_matrix_json):
            with open(align_matrix_json) as f:
                self.align = json.load(f)
        super().__init__(root, **kw)

    def _discover(self):
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d, "color"))
        )

    def _frame_ids(self, scene_id):
        color = os.path.join(self.root, scene_id, "color")
        return [f[:-4] for f in os.listdir(color) if f.endswith(".jpg")]

    def _load_frame(self, scene_id, fid):
        base = os.path.join(self.root, scene_id)
        if not hasattr(self, "_k_cache"):
            self._k_cache = {}
        if scene_id not in self._k_cache:  # scene-constant, parse once
            self._k_cache[scene_id] = scannet_depth_intrinsics(
                os.path.join(base, "intrinsic_depth.txt")
            )
        k = self._k_cache[scene_id]
        ext = load_matrix_txt(os.path.join(base, "pose", fid + ".txt"))
        rgb = _load_image(os.path.join(base, "color", fid + ".jpg"))
        depth = _load_depth_mm(os.path.join(base, "depth", fid + ".png"))
        return rgb, depth, k, ext[:3, :3], ext[:3, 3]

    def _gt_pcd(self, scene_id):
        if not self.sceneverse_root:
            return super()._gt_pcd(scene_id)
        pcd_dir = os.path.join(self.sceneverse_root, "pcd_with_global_alignment")
        paths = sorted(
            os.path.join(pcd_dir, f)
            for f in os.listdir(pcd_dir)
            if f.startswith(scene_id)
        )
        if not paths:
            return super()._gt_pcd(scene_id)
        align = None
        if scene_id in self.align:
            align = np.asarray(self.align[scene_id], np.float64)
        return load_sceneverse_pcd(paths, self.label_index, align)


class RScanScenes(_PosedFrameScenes):
    """3RScan ``sequence/frame-XXXXXX.*`` layout (``:1502-1551``)."""

    label_index = -1

    def __init__(self, root: str, sceneverse_root: Optional[str] = None, **kw):
        self.sceneverse_root = sceneverse_root
        super().__init__(root, **kw)

    def _discover(self):
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d, "sequence"))
        )

    def _frame_ids(self, scene_id):
        seq = os.path.join(self.root, scene_id, "sequence")
        stems = {
            f.split(".")[0]
            for f in os.listdir(seq)
            if f.endswith(".color.jpg")
        }
        return sorted(stems)

    def _load_frame(self, scene_id, fid):
        seq = os.path.join(self.root, scene_id, "sequence")
        if not hasattr(self, "_k_cache"):
            self._k_cache = {}
        if scene_id not in self._k_cache:  # scene-constant, parse once
            self._k_cache[scene_id] = rscan_intrinsics_from_info(
                os.path.join(seq, "_info.txt")
            )
        k = self._k_cache[scene_id]
        ext = load_matrix_txt(os.path.join(seq, fid + ".pose.txt"))
        rgb = _load_image(os.path.join(seq, fid + ".color.jpg"))
        depth = _load_depth_mm(os.path.join(seq, fid + ".depth.pgm"))
        return rgb, depth, k, ext[:3, :3], ext[:3, 3]

    def _gt_pcd(self, scene_id):
        if not self.sceneverse_root:
            return super()._gt_pcd(scene_id)
        path = os.path.join(
            self.sceneverse_root, "pcd_with_global_alignment", scene_id + ".pth"
        )
        if not os.path.exists(path):
            return super()._gt_pcd(scene_id)
        return load_sceneverse_pcd([path], self.label_index)


class ARKitScenes(_PosedFrameScenes):
    """ARKitScenes 3dod low-res layout (``:1818-1860``).

    Frame <-> pose pairing is by TIMESTAMP, not list position: filenames are
    ``<video>_<timestamp>.png`` with variable-digit timestamps (lexicographic
    order != chronological) and traj rows can be missing for dropped frames.
    Each frame matches the nearest traj row / ``.pincam`` within 1 ms — the
    official ARKitScenes toolkit's lookup rule; frames with no match within
    tolerance are skipped.
    """

    label_index = -1
    _ts_tol = 1e-3

    def __init__(self, root: str, sceneverse_root: Optional[str] = None, **kw):
        self.sceneverse_root = sceneverse_root
        self._scene_cache: Dict[str, Dict] = {}
        super().__init__(root, **kw)

    def _discover(self):
        out = []
        for d in sorted(os.listdir(self.root)):
            frames = os.path.join(self.root, d, d + "_frames")
            if os.path.isdir(os.path.join(frames, "lowres_wide")):
                out.append(d)
        return out

    @staticmethod
    def _name_ts(name: str) -> float:
        return float(name.rsplit("_", 1)[1].rsplit(".", 1)[0])

    def _scene_index(self, scene_id):
        if scene_id in self._scene_cache:
            return self._scene_cache[scene_id]
        frames = os.path.join(self.root, scene_id, scene_id + "_frames")
        with open(os.path.join(frames, "lowres_wide.traj")) as f:
            rows = [line.strip() for line in f if line.strip()]
        traj_ts = np.asarray([float(r.split()[0]) for r in rows])
        pincams = [
            f for f in os.listdir(os.path.join(frames, "lowres_wide_intrinsics"))
            if f.endswith(".pincam")
        ]
        pin_ts = np.asarray([self._name_ts(f) for f in pincams])
        idx = {"rows": rows, "traj_ts": traj_ts,
               "pincams": pincams, "pin_ts": pin_ts}
        self._scene_cache[scene_id] = idx
        return idx

    def _frame_ids(self, scene_id):
        frames = os.path.join(self.root, scene_id, scene_id + "_frames")
        wide = os.path.join(frames, "lowres_wide")
        return sorted(f for f in os.listdir(wide) if f.endswith(".png"))

    def _load_frame(self, scene_id, fid):
        frames = os.path.join(self.root, scene_id, scene_id + "_frames")
        idx = self._scene_index(scene_id)
        if not len(idx["traj_ts"]) or not len(idx["pin_ts"]):
            raise KeyError(f"scene {scene_id} has no traj rows or pincams")
        ts = self._name_ts(fid)
        ti = int(np.argmin(np.abs(idx["traj_ts"] - ts)))
        if abs(idx["traj_ts"][ti] - ts) > self._ts_tol:
            raise KeyError(f"no traj row within {self._ts_tol}s of {fid}")
        pi = int(np.argmin(np.abs(idx["pin_ts"] - ts)))
        if abs(idx["pin_ts"][pi] - ts) > self._ts_tol:
            raise KeyError(f"no pincam within {self._ts_tol}s of {fid}")
        k = pincam_intrinsics(
            os.path.join(frames, "lowres_wide_intrinsics", idx["pincams"][pi])
        )
        ext = traj_line_to_extrinsic(idx["rows"][ti])
        rgb = _load_image(os.path.join(frames, "lowres_wide", fid))
        depth = _load_depth_mm(os.path.join(frames, "lowres_depth", fid))
        return rgb, depth, k, ext[:3, :3], ext[:3, 3]

    def _gt_pcd(self, scene_id):
        if not self.sceneverse_root:
            return super()._gt_pcd(scene_id)
        path = os.path.join(
            self.sceneverse_root, "pcd_with_global_alignment", scene_id + ".pth"
        )
        if not os.path.exists(path):
            return super()._gt_pcd(scene_id)
        return load_sceneverse_pcd([path], self.label_index)


class Structured3DScenes(_PosedFrameScenes):
    """Structured3D perspective/full layout (``:2125-2160``).  The reference
    runs it label-free (SceneVerse block commented out, ``:2186-2216``), so
    ``use_labels=False`` by default."""

    label_index = 2

    def __init__(self, root: str, use_labels: bool = False, **kw):
        super().__init__(root, use_labels=use_labels, **kw)

    def _discover(self):
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d, "2D_rendering"))
        )

    def _frame_ids(self, scene_id):
        base = os.path.join(self.root, scene_id, "2D_rendering")
        out = []
        for room in sorted(os.listdir(base)):
            full = os.path.join(base, room, "perspective", "full")
            if not os.path.isdir(full):
                continue
            for view in sorted(os.listdir(full)):
                if os.path.exists(os.path.join(full, view, "camera_pose.txt")):
                    out.append(os.path.join(room, "perspective", "full", view))
        return out

    def _load_frame(self, scene_id, fid):
        view = os.path.join(self.root, scene_id, "2D_rendering", fid)
        rgb = _load_image(os.path.join(view, "rgb_rawlight.png"))
        depth = _load_depth_mm(os.path.join(view, "depth.png"))
        info = np.loadtxt(os.path.join(view, "camera_pose.txt"))
        rot, trans, k = parse_structured3d_camera(
            info, rgb.shape[0], rgb.shape[1]
        )
        # parse_camera_info returns world->camera axes rows; camera-to-world
        # is the transpose (orthonormal); the reference inverts the assembled
        # extrinsic the same way (``:2100-2102`` region)
        return rgb, depth, k, rot.T, trans


class HM3DSemanticIndex:
    """HM3D/MP3D semantic point-cloud index for the simulator walk driver.

    Mirrors the reference's preload (``ss_trainer_3DFF.py:75-94``): HM3D
    annotated scenes live at
    ``<hm3d_root>/<dirname>/<scene>.semantic.pth`` where ``scene`` is
    ``dirname[6:17]``; MP3D at ``<mp3d_root>/<scene>/<scene>_semantic.pth``.
    Blob layout (``:783-788``): xyz at index 0, instance_id -> object-type
    dict at index 1, instance label at index -1.  Scene ids from habitat
    episode paths are normalized the same way (``:775-778``: mp3d strips the
    extension, hm3d strips ``.basis.glb``).
    """

    def __init__(self, hm3d_root: Optional[str] = None,
                 mp3d_root: Optional[str] = None):
        self.paths: Dict[str, List[str]] = {}
        if hm3d_root and os.path.isdir(hm3d_root):
            for d in sorted(os.listdir(hm3d_root)):
                scene = d[6:17]
                p = os.path.join(hm3d_root, d, scene + ".semantic.pth")
                if os.path.exists(p):  # only a subset of scenes is annotated
                    self.paths.setdefault(scene, []).append(p)
        if mp3d_root and os.path.isdir(mp3d_root):
            for d in sorted(os.listdir(mp3d_root)):
                p = os.path.join(mp3d_root, d, d + "_semantic.pth")
                if os.path.exists(p):
                    self.paths.setdefault(d, []).append(p)

    @staticmethod
    def normalize_scene_id(scene_path: str) -> str:
        name = scene_path.split("/")[-1]
        if name.endswith(".basis.glb"):
            return name[: -len(".basis.glb")]
        return os.path.splitext(name)[0]

    def __contains__(self, scene_id: str) -> bool:
        return scene_id in self.paths

    def load(self, scene_id: str):
        """-> (xyz [G,3], label [G], instance_id -> object-type dict)."""
        xyzs, labels, id_to_type = [], [], {}
        for p in self.paths[scene_id]:
            blob = torch.load(p, map_location="cpu", weights_only=False)
            xyzs.append(np.asarray(blob[0], np.float32))
            labels.append(np.asarray(blob[-1]).astype(np.int32).reshape(-1))
            if isinstance(blob[1], dict):
                id_to_type.update(blob[1])
        return np.concatenate(xyzs, 0), np.concatenate(labels, 0), id_to_type


# ---------------------------------------------------------------------------
# language supervision assembly
# ---------------------------------------------------------------------------
def build_language_supervision(
    scene: Dict,
    annotations: Optional[SceneVerseAnnotations],
    category_dict: Dict[str, int],
    category_embeddings: np.ndarray,
    encode_text: Callable[[List[str]], np.ndarray],
    instance_labels: Optional[Dict[int, str]] = None,
    max_gt_label: int = 512,
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """gt-instance-id keyed supervision arrays for the pretrain step.

    For every gt instance id present in the scene pcd: draw a SceneVerse
    caption and CLIP-encode it (``:1313-1326``); else fall back to the
    instance's category embedding via ``instance_id_to_label``
    (``:1327-1334``, with the ``_``/``|``/``/`` -> space cleanup); else zeros.

    Returns ``(gtid_to_cat [L], gtid_text_fts [L, D], gtid_text_valid [L])``.
    """
    rng = rng or random.Random(0)
    labels = np.unique(scene["gt_label"])
    labels = labels[(labels >= 0) & (labels < max_gt_label)]
    d = category_embeddings.shape[1]
    gtid_to_cat = np.full((max_gt_label,), -1, np.int32)
    out_fts = np.zeros((max_gt_label, d), np.float32)
    valid = np.zeros((max_gt_label,), bool)

    captions: List[str] = []
    caption_rows: List[int] = []
    for gid in labels.tolist():
        cat_text = None
        if annotations is not None:
            cat_text = annotations.sample_caption(
                scene["scene_id"], gid, rng
            )
        if cat_text is not None:
            cat, caption = cat_text
            cat = cat.replace("_", " ").replace("|", " ").replace("/", " ")
            gtid_to_cat[gid] = category_dict.get(cat, -1)
            captions.append(caption)
            caption_rows.append(gid)
            valid[gid] = True
        elif instance_labels and gid in instance_labels:
            cat = (
                instance_labels[gid]
                .replace("_", " ").replace("|", " ").replace("/", " ")
            )
            idx = category_dict.get(cat, -1)
            gtid_to_cat[gid] = idx
            if idx >= 0:
                out_fts[gid] = category_embeddings[idx]
                valid[gid] = True

    if captions:
        enc = np.asarray(encode_text(captions), np.float32)
        for row, gid in enumerate(caption_rows):
            out_fts[gid] = enc[row]

    return gtid_to_cat, out_fts, valid
