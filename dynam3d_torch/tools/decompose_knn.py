"""Where kernel D (``csrc/knn_topk.cu``) spends its time, on the card, at the
renderer's stage-1 shape.

    python -m dynam3d_torch.tools.decompose_knn
    python -m dynam3d_torch.tools.decompose_knn --parent DIR

Each variant is a copy of the package under ``build/decompose_knn/<variant>/``
(gitignored; each copy builds its kernel into its own ``build/``) whose
source is patched:

  asis      : unchanged; its line also times every r of ``SWEEP_R``
              (queries a thread) on grids of 1 .. the blocks an SM holds
              per SM, beside the plan's own (the card's full wave);
  nostage   : the prologue only (compaction and split bounds), no k-NN;
  nocompare : the distance chains and each group's min per query are
              computed (the min folded into a running min), nothing is
              compared with a list or inserted;
  dense     : the compaction keeps every slot (dead ones at |p|^2 = +inf),
              so every slot is scanned, as the design before it did.

The variants run in a process each, in the order of ``ORDER`` (``asis``
first and last: the repeat shows the spread); with ``--parent DIR`` the
package of the checkout DIR (unpacked with ``git archive``) is timed as it
is before them and again after them.  Each prints one JSON line: the mean
device ms of one ``knn_topk_cuda`` call at Q = 72,144 ray samples (144
rays x 501) against the 32,768-slot table of 35 walk frames x 576 patches
(20,160 live), k = 4, each call after a 96 MB L2 flush by a read, by CUDA
events, the flushes subtracted (``decompose_int4_mma._time_ms``).  The
first line is the card's name and power limit.  Without a card it raises.

:func:`walk_table` and :func:`ray_samples` make that table and those
queries (``chip_smoke.py`` uses them too).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dynam3d_torch.tools.decompose_int4_mma import PACKAGE, ROOT, _time_ms, _variant, read_flush

WORK = ROOT / "build" / "decompose_knn"
ORDER = ("asis", "nostage", "nocompare", "dense", "asis")
SWEEP_R = (2, 4, 8)

# variant -> [(source in csrc/, the text replaced, its replacement)], for
# the design with the prologue (the design before it is timed as it is)
PATCHES = {
    "nostage": [("knn_topk.cu",
                 "  cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);",
                 "  (void)args;")],
    "nocompare": [("knn_topk.cu", "constexpr bool kCompare = true;",
                   "constexpr bool kCompare = false;")],
    "dense": [("knn_topk.cu", "  const bool keep = live;", "  const bool keep = p < np;")],
}


def walk_table(cfg, seed: int = 0, frames: int = 35, device="cuda", per_frame: int = 576):
    """A patch table filled the way a walk fills it: ``per_frame``
    frustum-clustered patches per frame around a drifting position, the
    rest of the ``cfg.patch_capacity`` slots dead at -10000.  Returns
    ``(pos [P, 3], valid [P], fts [n, fts_dim], dir [n], scale [n])``."""
    rng = np.random.default_rng(seed)
    pts, pos = [], np.array([0.0, 0.0, 1.3])
    for _ in range(frames):
        heading = rng.uniform(0, 2 * np.pi)
        depth = rng.uniform(0.5, 6.0, per_frame)
        ang = rng.uniform(-0.7, 0.7, per_frame)
        pts.append(np.stack([pos[0] + depth * np.cos(heading + ang),
                             pos[1] + depth * np.sin(heading + ang),
                             rng.uniform(0, 2.5, per_frame)], 1))
        pos[:2] += rng.uniform(-0.5, 0.5, 2)
    walk = np.concatenate(pts).astype(np.float32)
    n, P = walk.shape[0], cfg.patch_capacity
    table = np.full((P, 3), -10000.0, np.float32)
    table[:n] = walk
    valid = np.zeros(P, bool)
    valid[:n] = True
    return tuple(torch.from_numpy(a).to(device) for a in (
        table, valid, rng.normal(size=(n, cfg.fts_dim)).astype(np.float32),
        rng.uniform(0, 2 * np.pi, n).astype(np.float32),
        rng.uniform(0.01, 0.1, n).astype(np.float32)))


def ray_samples(cfg, position=(0.3, -0.2, 1.25), heading=0.7, device="cuda"):
    """World ray samples [R, NS, 3] of one habitat-camera novel view."""
    from dynam3d_torch.geom.projection import ray_grid_habitat

    (rx, ry, rz), _, _ = ray_grid_habitat(
        height=cfg.view_height, width=cfg.view_width, hfov_deg=cfg.view_hfov,
        vfov_deg=cfg.view_vfov, near=cfg.near, far=cfg.far, n_samples=cfg.n_samples)
    ch, sh = math.cos(heading), math.sin(heading)
    xyz = [rx * ch - ry * sh + position[0], rx * sh + ry * ch + position[1], rz + position[2]]
    return torch.stack([torch.from_numpy(a) for a in xyz], -1).to(device)


def design(package: Path) -> str:
    """``live`` when the package's kernel D stages the live points first."""
    src = (package / "csrc" / "knn_topk.cu").read_text()
    return "live" if "knn_stage_kernel" in src else "per_query"


def measure(name: str) -> dict:
    """This process's package (a variant's copy) on the card."""
    import dynam3d_torch
    from dynam3d_torch.config import FieldsConfig
    from dynam3d_torch.ops import knn

    if Path(dynam3d_torch.__file__).resolve().parents[1] != Path.cwd().resolve():
        raise RuntimeError("decompose: the variant did not import its own copy of the package")
    cfg = FieldsConfig()
    pts, valid = walk_table(cfg)[:2]
    q = ray_samples(cfg).reshape(-1, 3).contiguous()
    K = cfg.search_num
    flush = read_flush()
    out = {"D": _time_ms(lambda: knn.knn_topk_cuda(q, pts, valid, K), flush)}
    if hasattr(knn, "card_plan"):
        plan = knn.card_plan(q.device, q.shape[0], K)
        out["plan"] = dict(r=plan.r, tiles=plan.tiles, grid=plan.grid,
                           blocks_per_sm=plan.blocks_per_sm)
        if name.endswith(":asis"):
            for r in SWEEP_R:
                full = knn.card_plan(q.device, q.shape[0], K, r=r)
                for m in range(1, full.blocks_per_sm + 1):
                    p = knn.card_plan(q.device, q.shape[0], K, r=r,
                                      grid=m * full.sms)
                    out[f"D r={r} grid={p.grid}"] = _time_ms(
                        lambda: knn.knn_launch(q, pts, valid, K, p), flush)
    return out


def _copy(name: str, package: Path, tag: str = "") -> Path:
    patches = PATCHES if design(package) == "live" else {}
    return _variant(f"{tag}{name}", WORK, {f"{tag}{name}": patches.get(name, [])}, package)


def _env(d: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(d)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def _build(dirs) -> None:
    """Build every copy's kernel D at once, one process per copy."""
    code = "from dynam3d_torch.ops import kernels\nkernels.library('knn_topk')\n"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=d, env=_env(d))
             for d in dict.fromkeys(dirs)]
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("decompose: a variant's kernel did not build")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose kernel D is timed before and after this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("decompose_knn times the card: it needs a CUDA device")
    if args.measure:
        print(json.dumps(dict(variant=args.measure, ms=measure(args.measure))), flush=True)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    runs = [(f"{design(PACKAGE)}:{v}", _copy(v, PACKAGE)) for v in ORDER]
    if args.parent is not None:
        parent = args.parent.resolve() / PACKAGE.name
        p = (f"parent:{design(parent)}:asis", _copy("asis", parent, "parent_"))
        runs = [p] + runs + [p]
    _build(d for _, d in runs)
    for label, d in runs:
        # this file's measure() against the copy's package
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure", label],
                       cwd=d, env=_env(d), check=True)


if __name__ == "__main__":
    main()
