"""3DFF pretraining outer loop; port of ``runtime/pretrain_loop.py``
(``SyntheticFramesDataset``, ``synthetic_supervision``, ``WalkDriver``,
``pool_to_view``, ``PretrainRunner``).

Per iteration a host-agreed dataset draw picks a driver.  A posed-frames
dataset (``sample_scene``) goes through the device side of the batch (CLIP
over the frames, depth to the patch grid, patch geometry, segments,
novel-view targets) and one training step.  A :class:`WalkDriver`
(``run_iteration``) walks an episode of the simulator feed, accumulating
each step's gradients, and makes one update at its end.  Then the
iteration's scalars go to the logger and, every ``log_every`` iterations,
the trained ``fields`` and ``render`` to a checkpoint.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.geom.projection import (
    habitat_to_world, patch_geometry_from_pose, scale_intrinsics, unproject_depth_habitat,
    view_k,
)
from dynam3d_torch.models.encoders import clip as clip_mod
from dynam3d_torch.models.encoders.depth_resnet import preprocess_depth
from dynam3d_torch.models.memory3d import init_state
from dynam3d_torch.models.memory3d.state import stack_states
from dynam3d_torch.models.policy import nearest_resize_hw
from dynam3d_torch.models.policy_3dff import (
    candidates_from_heatmap, sample_waypoints_train, waypoint_heatmap,
)
from dynam3d_torch.models.segmenter import depth_plane_segments
from dynam3d_torch.runtime import checkpoint as ckpt_mod
from dynam3d_torch.runtime import profiling, trainer_3dff
from dynam3d_torch.runtime.feed import STOP, SyntheticRoomFeed
from dynam3d_torch.runtime.logging import MetricsLogger
from dynam3d_torch.utils.tree import tree_map


# a scene dict may carry its language supervision under these keys (as
# ``scene_datasets.build_language_supervision`` makes it); a frames
# iteration hands them to ``build_batch``, which draws random tables for
# those that are missing
SUPERVISION_KEYS = ("cat_embeddings", "gtid_to_cat", "gtid_text_fts")


class SyntheticFramesDataset:
    """Procedural posed-frames provider (the stand-in for the scannet /
    3rscan / arkit / structured3d disk loaders): ``frames`` random poses in
    the synthetic room, a random gt point cloud, and with ``posed=True``
    the pinhole K and camera-to-world ``(R, T)`` of each frame."""

    def __init__(self, rgb_size=56, depth_size=32, frames=4, seed=0, use_labels=True,
                 posed=False):
        self._feed = SyntheticRoomFeed(rgb_size=rgb_size, depth_size=depth_size, views=1,
                                       seed=seed)
        self.frames = frames
        self.use_labels = use_labels
        self.posed = posed
        self.depth_size = depth_size
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _extrinsic_from_pose(heading: float) -> np.ndarray:
        """Camera-to-world R of a level camera: x right, y down, z forward."""
        ch, sh = math.cos(heading), math.sin(heading)
        right = np.asarray([ch, sh, 0.0])
        down = np.asarray([0.0, 0.0, -1.0])
        forward = np.asarray([-sh, ch, 0.0])
        return np.stack([right, down, forward], axis=1).astype(np.float32)

    def sample_scene(self) -> Dict:
        self._feed.reset()
        rgbs, depths, poss, hds = [], [], [], []
        for _ in range(self.frames):
            pos = np.asarray([self.rng.uniform(1, 7), 1.25, self.rng.uniform(1, 7)], np.float32)
            hd = float(self.rng.uniform(0, 2 * math.pi))
            obs = self._feed.get_observation(pos, hd)
            rgbs.append(obs.rgb[0])
            depths.append(obs.depth[0])
            poss.append(pos)
            hds.append(hd)
        G = 128
        gt_xyz = self.rng.uniform(0, 8, (G, 3)).astype(np.float32)
        gt_xyz[:, 2] = self.rng.uniform(0, 2.5, G)
        scene = dict(rgb=np.stack(rgbs), depth=np.stack(depths), position=np.stack(poss),
                     heading=np.asarray(hds, np.float32), gt_xyz=gt_xyz,
                     gt_label=self.rng.integers(1, 32, G).astype(np.int32),
                     use_labels=self.use_labels)
        if self.posed:
            ds = self.depth_size
            k = np.eye(3, dtype=np.float32)
            k[0, 0] = k[1, 1] = ds / 2.0            # hfov 90 pinhole
            k[0, 2] = k[1, 2] = ds / 2.0
            p = np.stack(poss)
            world = np.stack([p[:, 0], -p[:, 2], p[:, 1]], axis=-1)
            rots = np.stack([self._extrinsic_from_pose(hds[i]) for i in range(self.frames)])
            scene.update(intrinsics=np.tile(k, (self.frames, 1, 1)), rot=rots,
                         trans=world.astype(np.float32))
        return scene


def synthetic_supervision(seed: int, fts_dim: int, n_points: int = 128, n_cats: int = 16,
                          max_label: int = 64) -> Dict:
    """Random gt point cloud and category / caption tables."""
    rng = np.random.default_rng(seed)
    gt_xyz = rng.uniform(0, 8, (n_points, 3)).astype(np.float32)
    gt_xyz[:, 2] = rng.uniform(0, 2.5, n_points)
    return dict(
        gt_xyz=gt_xyz,
        gt_label=rng.integers(1, max_label, n_points).astype(np.int32),
        cat_embeddings=rng.normal(size=(n_cats, fts_dim)).astype(np.float32),
        gtid_to_cat=rng.integers(-1, n_cats, max_label).astype(np.int32),
        gtid_text_fts=rng.normal(size=(max_label, fts_dim)).astype(np.float32),
        gtid_text_valid=np.ones((max_label,), bool),
    )


class WalkDriver:
    """The hm3d walk driver of 3DFF pretraining.

    Per episode the feed is reset, then each step (at most ``max_len``):

      1. the frozen waypoint heatmap of the 12-view depth panorama and its
         NMS candidates; with ``waypoint_aug`` each candidate's (angle,
         distance) is drawn from its sector's softmax instead;
      2. ``nv`` novel views: a random candidate's position
         (``feed.get_cand_real_pos``), a uniform heading in [-pi, pi), the
         feed's view there; their CLIP grids pooled to the view size are
         the render targets;
      3. one gradient of the walk step's loss (the panorama folded into the
         carried memory, the novel views rendered), added to the
         episode's sum;
      4. the next move: STOP at the last step; else with probability
         ``teacher_prob`` the teacher (STOP within ``stop_distance`` of the
         goal, else the candidate nearest it), otherwise a random
         candidate;

    then one optimizer update from the mean gradient.  ``self.rng`` is
    drawn in that order: the augmentation's choices, each novel view's
    candidate and heading, the teacher draw, the random candidate.
    """

    def __init__(self, feed, supervision: Dict, nv: int = 4, max_len: int = 5, seed: int = 0,
                 teacher_prob: float = 0.5, stop_distance: float = 1.5,
                 waypoint_aug: bool = True):
        self.feed = feed
        self.sup = supervision
        self.nv = nv
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self.teacher_prob = teacher_prob
        self.stop_distance = stop_distance
        self.waypoint_aug = waypoint_aug

    def _candidates(self, cfg: Dynam3DConfig, heat: torch.Tensor):
        """Host angles and distances of the step's candidates (float32)."""
        cand = candidates_from_heatmap(cfg, heat)
        mask = cand.mask[0].cpu().numpy()
        angles = cand.angles_ccw[0].cpu().numpy()[mask]
        dists = cand.distances[0].cpu().numpy()[mask]
        if self.waypoint_aug and len(angles):
            n_ang = cfg.waypoint.num_angles
            bins = np.round((2 * math.pi - angles) / (2 * math.pi) * n_ang).astype(np.int64) \
                % n_ang
            sa, sd = sample_waypoints_train(heat.cpu().numpy(), [bins.tolist()], self.rng)
            angles = 2 * math.pi - np.asarray(sa[0]) / n_ang * 2 * math.pi
            dists = (np.asarray(sd[0]) + 1) * 0.25
        if len(angles) == 0:           # a degenerate heatmap: a forward fan
            angles = np.asarray([0.0, math.pi / 2, -math.pi / 2])
            dists = np.asarray([0.5, 0.5, 0.5])
        return angles, dists

    def run_iteration(self, runner: "PretrainRunner") -> Dict[str, float]:
        cfg, dev = runner.cfg, runner.device
        for k in ("depth_enc", "waypoint"):
            if k not in runner.params:
                raise KeyError(f"WalkDriver needs frozen '{k}' parameters on the runner "
                               "(init_depth_params / init_waypoint_params)")
        trainable = {"fields": runner.params["fields"], "render": runner.params["render"]}
        frozen = {k: v for k, v in runner.params.items() if k not in trainable}
        runner._ensure_opt(trainable)

        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        sup = {k: put(self.sup[k]) for k in ("gt_xyz", "gt_label", "cat_embeddings",
                                              "gtid_to_cat", "gtid_text_fts", "gtid_text_valid")}
        gt_valid = torch.ones(self.sup["gt_xyz"].shape[0], dtype=torch.bool, device=dev)
        t_start = runner._sync()
        obs = self.feed.reset()
        state = stack_states([init_state(cfg.fields, dev)])
        grad_sum = tree_map(torch.zeros_like, trainable)
        per_step: List[Dict[str, torch.Tensor]] = []
        times = {"heatmap_s": 0.0, "views_s": 0.0, "grad_s": 0.0}

        for stepk in range(self.max_len):
            t0 = runner._sync()
            depth12 = put(obs.depth, np.float32)
            heat = runner._heatmap(frozen, depth12[None])
            angles, dists = self._candidates(cfg, heat)
            t1 = runner._sync()

            nv_pos, nv_hd, nv_rgb = [], [], []
            for _ in range(self.nv):
                k = int(self.rng.integers(0, len(angles)))
                pos = self.feed.get_cand_real_pos(float(angles[k]), float(dists[k]))
                hd = float(self.rng.uniform(-math.pi, math.pi))
                nv_pos.append(pos)
                nv_hd.append(hd)
                nv_rgb.append(self.feed.get_observation(pos, hd).rgb[0])
            with torch.no_grad():
                _, ngrid = runner._encode_views(runner.params["clip"], put(np.stack(nv_rgb)))
            batch = trainer_3dff.WalkBatch(
                rgb12=put(obs.rgb), depth12=depth12, position=put(obs.position, np.float32),
                heading=put(obs.heading, np.float32), gt_xyz=sup["gt_xyz"],
                gt_label=sup["gt_label"], gt_valid=gt_valid,
                novel_position=habitat_to_world(put(np.stack(nv_pos), np.float32)),
                novel_heading=put(nv_hd, np.float32), novel_gt_fts=pool_to_view(ngrid, cfg.fields),
                cat_embeddings=sup["cat_embeddings"], gtid_to_cat=sup["gtid_to_cat"],
                gtid_text_fts=sup["gtid_text_fts"], gtid_text_valid=sup["gtid_text_valid"],
                use_labels=torch.tensor(True, device=dev))
            t2 = runner._sync()
            grads, state, metrics = runner._walk_grad(trainable, frozen, state, batch)
            grad_sum = tree_map(torch.add, grad_sum, grads)
            per_step.append(metrics)
            t3 = runner._sync()
            times["heatmap_s"] += t1 - t0
            times["views_s"] += t2 - t1
            times["grad_s"] += t3 - t2

            if stepk == self.max_len - 1:
                action = STOP
            elif self.rng.uniform() < self.teacher_prob:
                cd = [self.feed.cand_dist_to_goal(float(a), float(d))
                      for a, d in zip(angles, dists)]
                if self.feed.oracle_distance(None) < self.stop_distance:
                    action = STOP
                else:
                    k = int(np.argmin(cd))
                    action = (float(angles[k]), float(dists[k]))
            else:
                k = int(self.rng.integers(0, len(angles)))
                action = (float(angles[k]), float(dists[k]))
            obs, done, _ = self.feed.step(action)
            if done or action == STOP:
                break

        t4 = runner._sync()
        new_tr, runner._tr_opt = trainer_3dff.apply_accumulated_grads(
            runner.opt, trainable, runner._tr_opt, grad_sum, len(per_step), dp=runner.dp)
        runner.params["fields"] = new_tr["fields"]
        runner.params["render"] = new_tr["render"]
        t5 = runner._sync()
        runner.timings.append(dict(times, update_s=t5 - t4, walk_s=t5 - t_start,
                                   walk_steps=len(per_step)))
        out = {k: float(np.mean([float(m[k]) for m in per_step])) for k in per_step[0]}
        out["walk_steps"] = float(len(per_step))
        return out


def pool_to_view(grid: torch.Tensor, f) -> torch.Tensor:
    """CLIP patch grid ``[N, g*g, D]`` -> view targets ``[N, R, D]``,
    average-pooled to ``view_height x view_width``."""
    N, GG, D = grid.shape
    g = int(math.sqrt(GG))
    vh, vw = f.view_height, f.view_width
    pool = grid.reshape(N, vh, g // vh, vw, g // vw, D).mean(dim=(2, 4))
    return pool.reshape(N, vh * vw, D)


class PretrainRunner:
    """The pretraining loop on one device (the card unless
    ``device="cpu"``).  ``params`` holds ``fields``, ``render`` and ``clip``
    on that device, and for a :class:`WalkDriver` the frozen ``depth_enc``
    and ``waypoint``; ``fields`` and ``render`` are trained.

    ``timings`` gets one record per iteration, host seconds between
    synchronized points: ``load_s`` (``sample_scene``: reading and
    decoding the frames), ``build_s`` and ``step_s`` for a frames
    iteration; for a walk the episode's ``walk_s``, its sums over steps
    ``heatmap_s`` (heatmap and candidates), ``views_s`` (novel views and
    their CLIP targets) and ``grad_s`` (the step's loss and gradients),
    the final ``update_s``, and ``walk_steps``.

    ``seed`` draws the synthetic supervision of a batch (``seed + it``);
    ``draw_seed`` (default ``seed``) each iteration's dataset.  ``dp``: a
    data-parallel group whose ranks share ``draw_seed``, so they draw the
    same dataset each iteration; a frames iteration then averages the
    ranks' gradients in its step, a walk its episode's mean gradient
    before the update (no collective runs inside a walk step, so walks of
    different lengths keep the lockstep)."""

    def __init__(self, params, cfg: Dynam3DConfig, seed: int = 0, device: DeviceLike = None,
                 dp=None, draw_seed: Optional[int] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.opt = trainer_3dff.make_pretrain_optimizer(cfg)
        self._steps = {}
        self._walk_grad = trainer_3dff.make_walk_grad_step(cfg)
        self.seed = seed
        self.draw_seed = seed if draw_seed is None else draw_seed
        self.dp = dp
        self.it = 0
        self.timings: List[Dict[str, float]] = []

    def _get_step(self, posed: bool):
        if posed not in self._steps:
            self._steps[posed] = trainer_3dff.make_pretrain_step(self.cfg, self.opt, posed=posed,
                                                                 dp=self.dp)
        return self._steps[posed]

    def _ensure_opt(self, trainable):
        if not hasattr(self, "_tr_opt"):
            self._tr_opt = self.opt.init(trainable)

    @torch.no_grad()
    def _heatmap(self, frozen, depth12: torch.Tensor) -> torch.Tensor:
        return waypoint_heatmap(frozen, self.cfg, depth12)

    def _encode_views(self, clip_params, rgb: torch.Tensor):
        pixels = clip_mod.preprocess_rgb(rgb, self.cfg.clip.image_size)
        if self.cfg.clip.compute_dtype == "bf16":
            pixels = pixels.to(torch.bfloat16)
        cls, grid = clip_mod.encode_image(clip_params, self.cfg.clip, pixels)
        return cls.to(torch.float32), grid.to(torch.float32)

    @torch.no_grad()
    def _build_device(self, clip_params, arrs, *, posed: bool, mode: str):
        """Device side of :meth:`build_batch`.  ``mode``: ``"reuse"`` (posed:
        the novel views are the input frames), ``"slice2"`` (unposed: frames
        0 and 1), ``"explicit"`` (caller's novel views, encoded here)."""
        f = self.cfg.fields
        H, W = f.input_height, f.input_width
        rgb = arrs["rgb"]
        depth = arrs["depth_u16"].to(torch.float32) * arrs["depth_scale"]
        V = rgb.shape[0]

        with profiling.span("pretrain.build.clip"):
            cls, grid = self._encode_views(clip_params, rgb)
        with profiling.span("pretrain.build.geometry"):
            d24 = nearest_resize_hw(depth, H, W)
            d24 = preprocess_depth(d24[..., None], (0.0, 10.0))[..., 0].reshape(V, H * W)
            world_pos = habitat_to_world(arrs["position"])
            headings = arrs["heading"]
            if posed:
                d_hw = tuple(depth.shape[1:3])
                geo = [patch_geometry_from_pose(
                    d24[v], scale_intrinsics(arrs["intrinsics"][v], d_hw, (H, W)),
                    arrs["rot"][v], arrs["trans"][v], H, W) for v in range(V)]
                novel_k = view_k(arrs["intrinsics"][0], d_hw, (f.view_height, f.view_width))
            else:
                geo = []
                for v in range(V):
                    rx, ry, rz, pd_, ps_ = unproject_depth_habitat(
                        d24[v], headings[v], height=H, width=W, hfov_deg=f.input_hfov,
                        vfov_deg=f.input_vfov)
                    geo.append((torch.stack([rx, ry, rz], -1) + world_pos[v][None, :], pd_, ps_))
                novel_k = torch.eye(3, dtype=torch.float32, device=self.device)
            ppos, pdir, pscale = (torch.stack(t) for t in zip(*geo))
            segm = depth_plane_segments(d24, H, W, f.max_segments)

        if mode == "reuse":
            ngrid, novel_pos, novel_hd = grid, world_pos, headings
        elif mode == "slice2":
            ngrid, novel_pos, novel_hd = grid[:2], world_pos[:2], headings[:2]
        else:
            _, ngrid = self._encode_views(clip_params, arrs["novel_rgb"])
            novel_pos = habitat_to_world(arrs["novel_position"])
            novel_hd = arrs["novel_heading"]
        return dict(cls=cls, grid=grid, d24=d24, segm=segm, world_pos=world_pos,
                    heading=headings, ppos=ppos, pdir=pdir, pscale=pscale, novel_pos=novel_pos,
                    novel_hd=novel_hd, novel_gt=pool_to_view(ngrid, f), novel_k=novel_k)

    def build_batch(self, scene: Dict, clip_params, novel_views: Optional[Dict] = None,
                    cat_embeddings: Optional[np.ndarray] = None,
                    gtid_to_cat: Optional[np.ndarray] = None,
                    gtid_text_fts: Optional[np.ndarray] = None,
                    max_gt_label: int = 512) -> trainer_3dff.PretrainBatch:
        D = self.cfg.fields.fts_dim
        posed = "intrinsics" in scene
        dev = self.device

        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        depth_np = np.asarray(scene["depth"], np.float32)
        # depth crosses to the device as uint16 plus one float scale
        dmax = float(depth_np.max()) if depth_np.size else 0.0
        dscale = (dmax / 65535.0) if dmax > 0 else 1.0
        arrs = {
            "rgb": put(scene["rgb"]),
            "depth_u16": put(np.clip(np.rint(depth_np / dscale), 0, 65535).astype(np.uint16)),
            "depth_scale": torch.tensor(np.float32(dscale), device=dev),
            "position": put(scene["position"], np.float32),
            "heading": put(scene["heading"], np.float32),
        }
        if posed:
            for k in ("intrinsics", "rot", "trans"):
                arrs[k] = put(scene[k], np.float32)
        if novel_views is not None:
            mode = "explicit"
            arrs["novel_rgb"] = put(novel_views["rgb"])
            arrs["novel_position"] = put(novel_views["position"], np.float32)
            arrs["novel_heading"] = put(novel_views["heading"], np.float32)
        elif posed:
            mode = "reuse"
            novel_views = {"rot": scene["rot"], "trans": scene["trans"]}
        else:
            mode = "slice2"
            novel_views = {}
        out = self._build_device(clip_params, arrs, posed=posed, mode=mode)
        Nv = out["novel_gt"].shape[0]

        C = 16 if cat_embeddings is None else cat_embeddings.shape[0]
        L = max_gt_label
        rng = np.random.default_rng(self.seed + self.it)
        if cat_embeddings is None:
            cat_embeddings = rng.normal(size=(C, D)).astype(np.float32)
        if gtid_to_cat is None:
            gtid_to_cat = rng.integers(-1, C, L).astype(np.int32)
        if gtid_text_fts is None:
            gtid_text_fts = rng.normal(size=(L, D)).astype(np.float32)

        rot = novel_views.get("rot", np.tile(np.eye(3, dtype=np.float32), (Nv, 1, 1)))
        trans = novel_views.get("trans", np.zeros((Nv, 3), np.float32))
        gt_xyz, gt_label = scene["gt_xyz"], scene["gt_label"]
        gt_valid = torch.ones(gt_xyz.shape[0], dtype=torch.bool, device=dev)
        if gt_xyz.shape[0] == 0:
            # no gt cloud (Structured3D runs label-free): one dead point of
            # label 0, so every nearest-gt lookup finds no instance
            gt_xyz, gt_label = np.zeros((1, 3), np.float32), np.zeros((1,), np.int32)
            gt_valid = torch.zeros(1, dtype=torch.bool, device=dev)
        return trainer_3dff.PretrainBatch(
            depth=out["d24"], grid_fts=out["grid"], cls_fts=out["cls"], segm=out["segm"],
            position=out["world_pos"], heading=out["heading"],
            gt_xyz=put(gt_xyz), gt_label=put(gt_label), gt_valid=gt_valid,
            novel_position=out["novel_pos"], novel_heading=out["novel_hd"],
            novel_gt_fts=out["novel_gt"], novel_k=out["novel_k"],
            novel_rot=put(rot, np.float32), novel_trans=put(trans, np.float32),
            cat_embeddings=put(cat_embeddings), gtid_to_cat=put(gtid_to_cat),
            gtid_text_fts=put(gtid_text_fts),
            gtid_text_valid=torch.ones(L, dtype=torch.bool, device=dev),
            use_labels=torch.tensor(bool(scene.get("use_labels", True)), device=dev),
            ppos=out["ppos"], pdir=out["pdir"], pscale=out["pscale"],
        )

    def _sync(self) -> float:
        if self.device.type == "cuda":
            profiling.count("sync")
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def run(self, datasets: Sequence, iters: int, logger: Optional[MetricsLogger] = None,
            ckpt_dir: Optional[str] = None, log_every: int = 100) -> List[Dict[str, float]]:
        """``iters`` training iterations over providers with
        ``sample_scene()`` or ``run_iteration(runner)``; returns each
        iteration's scalars, which also go to ``logger`` under ``loss/``.
        Every ``log_every`` iterations ``{"fields", "render"}`` is saved to
        ``ckpt_dir/ckpt.iter{it}``."""
        history = []
        for _ in range(iters):
            ds = datasets[trainer_3dff.draw_dataset_id(self.draw_seed, self.it, len(datasets))]
            if hasattr(ds, "run_iteration"):
                m = ds.run_iteration(self)
            else:
                m = self._frames_iteration(ds)
            history.append(m)
            if logger:
                logger.add_scalars(m, self.it, prefix="loss/")
            if ckpt_dir and (self.it + 1) % log_every == 0:
                ckpt_mod.save_checkpoint(ckpt_dir, self.it + 1,
                                         {"fields": self.params["fields"],
                                          "render": self.params["render"]})
            self.it += 1
        return history

    def _frames_iteration(self, ds) -> Dict[str, float]:
        """One frames iteration.  Its spans (``runtime/profiling.py``,
        each carrying the iteration as its step): ``pretrain.iter`` to the
        closing synchronize; ``pretrain.load`` (``sample_scene``);
        ``pretrain.build`` to the synchronize after the batch, with
        ``.clip`` and ``.geometry``; the step's ``pretrain.fold``,
        ``.losses`` (a ``pretrain.render`` a novel view), ``.backward`` and
        ``.update``.  The metrics' reads lie in ``pretrain.iter`` alone."""
        profiling.set_step(self.it)
        with profiling.span("pretrain.iter"):
            profiling.count("pretrain.iters")
            t_load = self._sync()
            with profiling.span("pretrain.load"):
                scene = ds.sample_scene()
            t0 = time.perf_counter()
            with profiling.span("pretrain.build"):
                sup = {k: scene[k] for k in SUPERVISION_KEYS if k in scene}
                batch = self.build_batch(scene, self.params["clip"], **sup)
                t1 = self._sync()
            trainable = {"fields": self.params["fields"], "render": self.params["render"]}
            self._ensure_opt(trainable)
            step = self._get_step(posed="intrinsics" in scene)
            new_tr, self._tr_opt, _, metrics = step(trainable, self._tr_opt,
                                                    init_state(self.cfg.fields, self.device), batch)
            self.params["fields"] = new_tr["fields"]
            self.params["render"] = new_tr["render"]
            profiling.count("sync", len(metrics) - 1)      # "skipped" is a host value
            m = {k: float(v) for k, v in metrics.items()}
            t2 = self._sync()
        self.timings.append({"load_s": t0 - t_load, "build_s": t1 - t0, "step_s": t2 - t1})
        return m
