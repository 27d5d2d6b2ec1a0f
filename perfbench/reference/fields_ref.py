"""The plain reference of one 3D Feature Fields ("3DFF") pretraining step
on a posed-frames scene, in plain PyTorch.

Written from the pretraining's semantics (Dynam3D, arXiv:2505.11383, and
its stage-1 trainer ``ss_trainer_3DFF.py``), not from the program's code:
the batch is built from the scene as the dataset gave it, the views are
folded one segment, one merged instance and one zone at a time over
exactly their members, the novel views are rendered with an exact k-NN,
and the loss family, its gradient, the per-value clip and AdamW follow.
Every product and sum is float32 (TF32 is switched off); values are
rounded where the configuration states a lower precision: the frozen CLIP
tower and the fold's aggregation encoders compute in bf16 (the encoders
in float32 where ``encoder_dtype`` says so), the NeRF MLP rounds its
inputs, weights and hidden activations to bf16 and sums in float32, the
rest stays float32.  The backward pass is float32 autograd; a rounding is
taken as the identity there.

Departures from the published description, each on purpose:

* The scene's depth enters as float32 (the program moves it to the card as
  uint16 and one scale).
* The segments are the connected components of 4-neighbour patches whose
  metric depths differ by at most 8% of the larger (the ``depth_plane``
  provider the synthetic scenes use in place of FastSAM), numbered by their
  first patch.  One pair of patches at the threshold joins or splits two
  segments and renumbers every later one, so choices are compared by
  pair (:func:`same_segment`).
* The pretraining's pseudo-zone prediction runs the instance-to-zone
  encoder at the tables' float32, as the pretraining package does.
* The gradient is taken view by view: the loss's gradient with respect to
  each view's byproducts, then that view's fold differentiated from the
  table before it.  The tables enter each view with their features
  detached, so the sum is the whole gradient (``grad_by_view=False``
  differentiates the whole graph at once, which small configurations use
  to show that); sixteen views' re-aggregations over thousands of member
  patches would not fit on one card at once.
* ``follow``: the discrete choices that can tie within rounding (each
  segment's merge or new instance, the segment ids, the renderer's kept
  samples of a ray, the neighbours of a kept sample, whose order decides
  which slot of the conditioning each one fills, and the focal loss's
  hardest rays, whose weight in the gradient is many times another ray's)
  are taken from the
  compared side where it made one, and every disagreement with the
  reference's own choice beyond a tie is counted (a merge: a logit
  margin of ``MERGE_TIE`` or more), so that one near-tie does not move
  every later slot of the tables.
* One precision step down (``low=True``, the control) rounds the fold
  encoders' and the NeRF MLP's matrix-product inputs to fp8 (e4m3, one
  scale per tensor) where the configuration states bf16.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import perception as P

BF16 = torch.bfloat16
NEG_SLOPE = 0.01              # the NeRF MLP's LeakyReLU
LOGIT_SCALE = 10.0
KNN_BLOCK = 4096              # queries a block of the exact k-NN
NB_TIE = 1e-4                 # m^2: squared neighbour distances this close tie
KEEP_TIE = 1e-3               # m: summed neighbour distances of samples this close tie
FOCAL_TIE = 0.1               # nats: cross entropies this close tie for the hardest rays
MERGE_TIE = 0.05              # a merge logit margin this small ties


# --- configuration and trees --------------------------------------------------

def config(model: Dict) -> SimpleNamespace:
    """The configuration file's ``model`` object as attribute namespaces."""
    from perfbench.reference.config import _ns

    cfg = _ns(model)
    cfg.clip.grid = cfg.clip.image_size // cfg.clip.patch_size
    return cfg


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in insertion order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def rebuild(tree, values: List[torch.Tensor]):
    """A tree shaped like ``tree`` holding ``values`` in :func:`leaves` order."""
    it = iter(values)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)

    return rec(tree)


# --- rounding -----------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    return (x.detach() / s).to(torch.float8_e4m3fn).float() * s


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` rounded to ``prec`` ("f32", "bf16" or "fp8") in value, float32
    in dtype; the gradient passes as through the identity."""
    x = x.float()
    if prec == "f32":
        return x
    r = x.detach().to(BF16).float() if prec == "bf16" else _fp8(x)
    return x + (r - x.detach())


def _lower(prec: str, low: bool) -> str:
    return "fp8" if low and prec == "bf16" else prec


class Precision:
    """Where the step rounds: ``enc`` the aggregation encoders, ``mlp`` the
    NeRF MLP; ``low`` one step down (bf16 becomes fp8)."""

    def __init__(self, cfg, low: bool = False):
        enc = "bf16" if cfg.fields.encoder_dtype == "bf16" else "f32"
        self.enc = _lower(enc, low)
        self.enc_values = enc               # the dtype the encoder's values take
        self.mlp = _lower("bf16", low)


# --- layers -------------------------------------------------------------------

def _ln(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _dense(p: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    return rnd(x, prec) @ rnd(p["w"], prec) + p["b"]


def mlp2(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Linear, LayerNorm, exact GELU, Linear, in float32."""
    h = _ln(p["ln"], x @ p["fc1"]["w"] + p["fc1"]["b"], 1e-5)
    return F.gelu(h) @ p["fc2"]["w"] + p["fc2"]["b"]


def encoder(p: Dict, x: torch.Tensor, prec: str, values: str) -> torch.Tensor:
    """Post-norm transformer layers (exact GELU, heads of 64) over exactly
    the tokens ``x [T, D]``, then a final LayerNorm at eps 1e-12; products
    take inputs rounded to ``prec``, activations are rounded to
    ``values`` between operations."""
    T, D = x.shape
    heads = max(1, D // 64)
    hd = D // heads
    v_ = (lambda t: rnd(t, values))
    x = v_(x)
    for lp in p["layers"]:
        q, k, v = v_(_dense(lp["attn"]["qkv"], x, prec)).split(D, dim=-1)
        q, k, v = (t.reshape(T, heads, hd).transpose(0, 1) for t in (q, k, v))
        a = torch.softmax((rnd(q, prec) @ rnd(k, prec).transpose(1, 2)) / math.sqrt(hd), -1)
        o = (rnd(v_(a), prec) @ rnd(v, prec)).transpose(0, 1).reshape(T, D)
        x = v_(_ln(lp["ln1"], v_(x + v_(_dense(lp["attn"]["out"], v_(o), prec))), 1e-5))
        h = v_(F.gelu(v_(_dense(lp["ff1"], x, prec))))
        x = v_(_ln(lp["ln2"], v_(x + v_(_dense(lp["ff2"], h, prec))), 1e-5))
    return v_(_ln(p["final_ln"], x, 1e-12))


def _aggregate(agg: torch.Tensor, enc: Dict, tokens: torch.Tensor, prec: str,
               values: str) -> torch.Tensor:
    """The [AGG] token's output over ``[AGG] + tokens``."""
    return encoder(enc, torch.cat([agg.float(), tokens], 0), prec, values)[0]


def _merge_disc(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(_ln(p["ln"], x @ p["fc1"]["w"] + p["fc1"]["b"], 1e-5))
    return h @ p["fc2"]["w"] + p["fc2"]["b"]


# --- the batch ----------------------------------------------------------------

def clip_features(p: Dict, c, rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 views ``[V, N, N, 3]`` -> (CLS ``[V, E]``, patches ``[V, G*G, E]``),
    float32 holding bf16 values."""
    x = P.clip_hidden(p, c, P.clip_pixels(rgb, c.image_size), c.vision_layers)
    v = p["visual"]
    cls = P._mm(P.norm(v["ln_post"], x[:, 0]), v["proj"], BF16).to(BF16)
    grid = P._mm(P.norm(v["ln_post"], x[:, 1:]), v["proj"], BF16).to(BF16)
    return cls.float(), grid.float()


def segments(depth: np.ndarray, h: int, w: int, max_segments: int,
             rel: float = 0.08) -> np.ndarray:
    """Connected components of 4-neighbour patches whose depths differ by
    at most ``rel`` of the larger, numbered by their first patch (row
    major); ids past ``max_segments - 1`` collapse into the last."""
    d = depth.reshape(h, w).astype(np.float32)
    ids = -np.ones((h, w), np.int64)
    n = 0
    for r0 in range(h):
        for c0 in range(w):
            if ids[r0, c0] >= 0:
                continue
            ids[r0, c0] = n
            stack = [(r0, c0)]
            while stack:
                r, c = stack.pop()
                for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                    if 0 <= rr < h and 0 <= cc < w and ids[rr, cc] < 0 and \
                            abs(d[rr, cc] - d[r, c]) <= rel * max(d[rr, cc], d[r, c]):
                        ids[rr, cc] = n
                        stack.append((rr, cc))
            n += 1
    return np.minimum(ids.reshape(-1), max_segments - 1)


def same_segment(segm: torch.Tensor, f) -> torch.Tensor:
    """For each pair of 4-neighbour patches of each view (``segm [V,
    HW]``), whether they share a segment: the partition, whatever the
    segments' numbers."""
    g = segm.reshape(-1, f.input_height, f.input_width)
    return torch.cat([(g[:, :, 1:] == g[:, :, :-1]).flatten(1),
                      (g[:, 1:] == g[:, :-1]).flatten(1)], 1)


def patch_geometry(f, depth: torch.Tensor, cam: torch.Tensor, heading: float):
    """Metric depth ``[HW]`` of a level habitat camera at world ``cam`` and
    ``heading`` -> world positions ``[HW, 3]``, directions and footprints."""
    H, W = f.input_height, f.input_width
    tx, tz = P.tangents(H, W, f.input_hfov, f.input_vfov, depth.device)
    dx, dz = depth * tx, depth * tz
    c, s = math.cos(heading), math.sin(heading)
    pos = torch.stack([dx * c - depth * s, dx * s + depth * c, dz], -1) + cam
    direction = torch.remainder(-torch.atan(tx) + heading, 2 * math.pi)
    scale = depth * (math.tan(math.pi * f.input_hfov / 360.0) * 2.0 / W)
    return pos, direction, scale


def build(params: Dict, cfg, scene: Dict, device) -> Dict[str, Any]:
    """The step's inputs from the scene: CLIP over the frames, metric depth
    at the patch grid, the segments, the cameras, and the first two frames
    as the novel views with their CLIP grids pooled to the view size."""
    f = cfg.fields
    H, W = f.input_height, f.input_width
    rgb = torch.as_tensor(np.asarray(scene["rgb"]), device=device)
    depth = torch.as_tensor(np.asarray(scene["depth"], np.float32), device=device)
    V = rgb.shape[0]
    cls, grid = clip_features(params["clip"], cfg.clip, rgb)
    d24 = P.metric_depth(P.nearest(depth, H, W)).reshape(V, H * W)
    d_host = d24.cpu().numpy()
    segm = torch.as_tensor(np.stack([segments(d_host[v], H, W, f.max_segments)
                                     for v in range(V)]), device=device)
    cams = P.to_world(torch.as_tensor(np.asarray(scene["position"], np.float32), device=device))
    headings = [float(h) for h in np.asarray(scene["heading"], np.float32)]
    g = cfg.clip.grid
    vh, vw = f.view_height, f.view_width
    pooled = grid[:2].reshape(2, vh, g // vh, vw, g // vw, -1).mean(dim=(2, 4))
    return {"cls": cls, "grid": grid, "depth": d24, "segm": segm, "cams": cams,
            "headings": headings, "novel": [(cams[i], headings[i]) for i in range(2)],
            "novel_gt": pooled.reshape(2, vh * vw, -1)}


# --- the fold -----------------------------------------------------------------

def empty_table(f, device) -> Dict[str, torch.Tensor]:
    return {k: v[0] for k, v in P.empty_state(f, 1, device)._asdict().items()}


def _nearest_ids(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """The nearest of ``points`` to each query (the lower index on a tie)."""
    out = []
    for q in queries.split(KNN_BLOCK):
        out.append(((q[:, None, :] - points[None]) ** 2).sum(-1).argmin(-1))
    return torch.cat(out)


def _segment_gt(f, segm, pos, gt) -> torch.Tensor:
    """Each segment's majority gt instance id among its patches' nearest gt
    points (the smallest id on a tie), -1 for an empty segment."""
    S, L = f.max_segments, gt["max_label"]
    xyz, lab = gt["xyz"][gt["valid"]], gt["label"][gt["valid"]]
    labels = lab[_nearest_ids(pos, xyz)].long().clamp(0, L - 1)
    counts = torch.zeros(S, L, dtype=torch.int64, device=pos.device)
    counts.index_put_((segm, labels), torch.ones_like(labels), accumulate=True)
    return torch.where(counts.sum(-1) > 0, counts.argmax(-1), torch.full((S,), -1,
                                                                        device=pos.device))


def _first_free(valid: torch.Tensor, n: int) -> List[int]:
    free = torch.nonzero(~valid).flatten().tolist()
    return [free[i] if i < len(free) else valid.shape[0] - 1 for i in range(n)]


def fold_view(pf: Dict, t: Dict[str, torch.Tensor], f, prec: Precision, x: Dict,
              gt: Dict, follow: Optional[Dict] = None, decide: Optional[Dict] = None):
    """Fold one view into the table ``t`` (returned anew; the features of
    the table before enter detached) and the view's pretraining byproducts.
    ``x``: ``depth [HW]`` metres, ``grid [HW, D]``, ``segm [HW]``, ``cam``,
    ``heading``.  ``follow``: the compared side's ``is_merge`` and
    ``owner`` ``[S]``; ``decide``: choices to take as they are (a
    recomputation of the same view)."""
    S, K, D = f.max_segments, f.num_proposal_instances, f.fts_dim
    P_cap = f.patch_capacity
    dev = x["depth"].device
    t = {k: v.detach().clone() for k, v in t.items()}
    pre = {k: v.clone() for k, v in t.items()}
    pos, direction, scale = patch_geometry(f, x["depth"], x["cam"], x["heading"])
    grid, segm = x["grid"], x["segm"].long()
    HW = grid.shape[0]
    seg_gt = _segment_gt(f, segm, pos, gt)

    # patches: the free slots in order, then the oldest live ones
    valid = t["patch_valid"]
    free = torch.nonzero(~valid).flatten()
    if free.numel() < HW:
        live = torch.nonzero(valid).flatten()
        age = t["patch_step"][live] * P_cap + live
        free = torch.cat([free, live[torch.argsort(age)][: HW - free.numel()]])
    slots = torch.sort(free[:HW]).values
    stamp = int(t["patch_step"].max()) + 1
    t["patch_owner"][slots] = -1
    t["patch_pos"][slots] = pos
    t["patch_fts"][slots] = grid.to(t["patch_fts"].dtype)
    t["patch_dir"][slots] = direction
    t["patch_scale"][slots] = scale
    t["patch_valid"][slots] = True
    t["patch_step"][slots] = stamp

    # each segment over its own patches
    active = sorted(set(segm.tolist()))
    act = torch.zeros(S, dtype=torch.bool, device=dev)
    act[active] = True
    centers = torch.zeros(S, 3, device=dev)
    target = torch.zeros(S, D, device=dev)
    feats = []
    for sid in active:
        m = segm == sid
        centers[sid] = pos[m].mean(0)
        target[sid] = grid[m].mean(0)
        tok = grid[m] + mlp2(pf["patch_pos_mlp"], P._embed_in(
            pos[m], centers[sid].expand(int(m.sum()), 3), direction[m], scale[m]))
        feats.append(_aggregate(pf["p2i_agg_token"], pf["p2i_encoder"], tok, prec.enc,
                                prec.enc_values))
    idx = torch.tensor(active, device=dev)
    seg_fts = torch.zeros(S, D, device=dev).index_put((idx,), torch.stack(feats))

    # merge proposals: the K nearest live instances of the table before
    live_i = torch.nonzero(pre["inst_valid"]).flatten()
    prop = {}
    for sid in active:
        d2 = ((pre["inst_pos"][live_i] - centers[sid]) ** 2).sum(-1)
        order = torch.sort(d2, stable=True).indices[:K]
        prop[sid] = [(int(live_i[o]), float(d2[o])) for o in order]
    # a rank some segment cannot fill (or fills past the dead distance) is
    # offered to none, nor is any rank after it
    ranks = next((k for k in range(K) if any(len(prop[s]) <= k or prop[s][k][1] >= P.DEAD
                                             for s in active)), K)
    logit = torch.zeros(S, K, device=dev)
    mtarget = torch.zeros(S, K, dtype=torch.int64, device=dev)
    mvalid = torch.zeros(S, K, dtype=torch.bool, device=dev)
    lg = {}
    for sid in active:
        for k, (i, _) in enumerate(prop[sid]):
            z = torch.cat([pre["inst_fts"][i], seg_fts[sid], centers[sid] - pre["inst_pos"][i]])
            out = _merge_disc(pf["merge_disc"], z)
            lg[sid, k] = out
            logit[sid, k] = out[1] - out[0]
            g = int(seg_gt[sid])
            mtarget[sid, k] = int(g >= 0 and int(pre["inst_gt_id"][i]) == g)
            mvalid[sid, k] = g >= 0
    own, taken, off = {}, {}, 0
    for sid in active:
        own[sid] = next((prop[sid][k][0] for k in range(ranks)
                         if bool(lg[sid, k][1] > lg[sid, k][0])), None)
        choice = own[sid]
        if decide is not None:
            choice = decide[sid]
        elif follow is not None:
            fm, fo = bool(follow["is_merge"][sid]), int(follow["owner"][sid])
            allowed = {prop[sid][k][0] for k in range(ranks)}
            if not fm:
                choice = None
            elif fo in allowed:
                choice = fo
            margin = min((abs(float(logit[sid, k])) for k in range(ranks)), default=math.inf)
            off += int(choice != own[sid] and margin >= MERGE_TIE)
        taken[sid] = choice
    new = [sid for sid in active if taken[sid] is None]
    owner = torch.full((S,), -1, dtype=torch.int64, device=dev)
    inst_fts = t["inst_fts"]
    new_slots = _first_free(pre["inst_valid"], len(new))
    for sid, slot in zip(new, new_slots):
        owner[sid] = slot
        t["inst_pos"][slot] = centers[sid]
        t["inst_valid"][slot] = True
        t["inst_gt_id"][slot] = seg_gt[sid]
    if new:
        inst_fts = inst_fts.index_put((torch.tensor(new_slots, device=dev),),
                                      seg_fts[torch.tensor(new, device=dev)])
    for sid in active:
        if taken[sid] is not None:
            owner[sid] = taken[sid]
    t["patch_owner"][slots] = owner[segm]

    # each merged instance again, over its members (the lowest slots first)
    merged = sorted({taken[s] for s in active if taken[s] is not None})
    mfeats = []
    for i in merged:
        mem = torch.nonzero(t["patch_valid"] & (t["patch_owner"] == i)).flatten()[: f.max_members]
        mpos = t["patch_pos"][mem]
        center = mpos.mean(0)
        tok = t["patch_fts"][mem].float() + mlp2(pf["patch_pos_mlp"], P._embed_in(
            mpos, center.expand_as(mpos), t["patch_dir"][mem], t["patch_scale"][mem]))
        t["inst_pos"][i] = center
        mfeats.append(_aggregate(pf["p2i_agg_token"], pf["p2i_encoder"], tok, prec.enc,
                                 prec.enc_values))
    if merged:
        inst_fts = inst_fts.index_put((torch.tensor(merged, device=dev),), torch.stack(mfeats))

    # zones: each cell a segment's centre falls in (sorted), against the zone
    # table before the view; a cell with no live instance is skipped
    cells = torch.unique(P.zone_cell(centers[idx], f), dim=0)
    inst_cells = P.zone_cell(t["inst_pos"], f)
    free_z = _first_free(pre["zone_valid"], cells.shape[0])
    n_new, zrows, zvals = 0, [], []
    for cell in cells:
        members = torch.nonzero(t["inst_valid"] & ((inst_cells - cell).abs() < P.KEY_EPS).all(-1)
                                ).flatten()[: f.max_zone_members]
        same = torch.nonzero(pre["zone_valid"] & ((pre["zone_key"] - cell).abs() < P.KEY_EPS
                                                  ).all(-1)).flatten()
        if members.numel() == 0:
            continue
        if same.numel():
            zid, mpos = int(same[0]), cell.expand(members.numel(), 3)
        else:
            zid, mpos = free_z[n_new], t["inst_pos"][members]
            n_new += 1
        zpos = mpos.mean(0)
        emb = torch.cat([mpos - zpos, mpos.norm(dim=-1, keepdim=True)], -1)
        tok = inst_fts[members] + mlp2(pf["inst_pos_mlp"], emb)
        t["zone_key"][zid], t["zone_pos"][zid] = cell, zpos
        t["zone_valid"][zid] = True
        zrows.append(zid)
        zvals.append(_aggregate(pf["i2z_agg_token"], pf["i2z_encoder"], tok, prec.enc,
                                prec.enc_values))
    zone_fts = t["zone_fts"]
    if zrows:
        zone_fts = zone_fts.index_put((torch.tensor(zrows, device=dev),), torch.stack(zvals))
    t["inst_fts"], t["zone_fts"] = inst_fts, zone_fts

    # the view's pseudo-zone prediction over its segments, at float32
    c_act = centers[idx]
    emb = torch.cat([c_act - c_act.mean(0), c_act.norm(dim=-1, keepdim=True)], -1)
    ztok = seg_fts[idx] + mlp2(pf["inst_pos_mlp"], emb)
    zone_pred = _aggregate(pf["i2z_agg_token"], pf["i2z_encoder"], ztok, "f32", "f32")

    # the touched instances and zones after the view
    own_c = owner.clamp(min=0)
    inst_pred = torch.where(act[:, None], inst_fts[own_c], torch.zeros_like(inst_fts[own_c]))
    inst_gt = torch.where(act, t["inst_gt_id"][own_c], torch.full_like(own_c, -1))
    zpred = torch.zeros(S, D, device=dev)
    zgt = torch.full((S,), -1, dtype=torch.int64, device=dev)
    ztouch = torch.zeros(S, dtype=torch.bool, device=dev)
    inst_cells = P.zone_cell(t["inst_pos"], f)
    zrow_fts = []
    for r, cell in enumerate(cells):
        hit = torch.nonzero(t["zone_valid"] & ((t["zone_key"] - cell).abs() < P.KEY_EPS
                                               ).all(-1)).flatten()
        if hit.numel():
            ztouch[r] = True
            zrow_fts.append((r, int(hit[0])))
        mem = torch.nonzero(t["inst_valid"] & ((inst_cells - cell).abs() < P.KEY_EPS).all(-1)
                            ).flatten()
        if mem.numel():
            zgt[r] = t["inst_gt_id"][mem[0]]
    if zrow_fts:
        rr = torch.tensor([a for a, _ in zrow_fts], device=dev)
        zz = torch.tensor([b for _, b in zrow_fts], device=dev)
        zpred = zpred.index_put((rr,), zone_fts[zz])

    aux = {"seg_fts": seg_fts, "seg_active": act, "centers": centers, "seg_gt": seg_gt,
           "target": target, "patch_mean": grid.mean(0), "zone_pred": zone_pred,
           "merge_logit": logit, "merge_target": mtarget,
           "merge_valid": mvalid & act[:, None] & (torch.arange(K, device=dev)[None, :]
                                                   < torch.tensor([len(prop.get(s, []))
                                                                   for s in range(S)],
                                                                  device=dev)[:, None]),
           "inst_pred": inst_pred, "inst_gt": inst_gt, "zone_pred_zone": zpred,
           "zone_gt": zgt, "zone_touch": ztouch,
           "is_merge": torch.tensor([s in active and taken[s] is not None for s in range(S)],
                                    device=dev),
           "owner": owner}
    return t, aux, {"taken": taken, "merges_off": off, "segments": len(active)}


# --- the renderer -------------------------------------------------------------

def knn(queries: torch.Tensor, points: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact distances (ascending) and ids of the ``k`` nearest points,
    the lower id first on a tie; blocks of ``KNN_BLOCK`` queries."""
    ds, ids = [], []
    for q in queries.split(KNN_BLOCK):
        d2 = ((q[:, None, :] - points[None]) ** 2).sum(-1)
        s = torch.sort(d2, dim=1, stable=True)
        ds.append(s.values[:, :k].sqrt())
        ids.append(s.indices[:, :k])
    return torch.cat(ds), torch.cat(ids)


def nerf_mlp(p: Dict, x: torch.Tensor, prec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder (+density) -> residual -> decoder, every product over inputs
    rounded to ``prec``, each LeakyReLU in float32 before its output is
    rounded; features and density come out rounded."""
    xr = rnd(x, prec)
    h = xr
    for w in p["enc_hidden"]:
        h = rnd(F.leaky_relu(h @ rnd(w, prec), NEG_SLOPE), prec)
    o = F.leaky_relu(h @ rnd(p["enc_out"], prec), NEG_SLOPE)
    h = rnd(o[:, :-1] + xr, prec)
    for w in p["dec_hidden"]:
        h = rnd(F.leaky_relu(h @ rnd(w, prec), NEG_SLOPE), prec)
    return rnd(h @ rnd(p["dec_out"], prec), prec), rnd(o[:, -1], prec)


def _follow_kept(rays, dsum, keep, theirs_pos):
    """The compared side's kept samples of each ray (in their order) where
    they tie with the reference's own: their summed neighbour distances,
    sorted, equal the reference's best within ``KEEP_TIE`` and come in
    non-decreasing order within it.  Returns the indices to keep and the
    count of rays whose kept samples differ beyond a tie."""
    R, NI = keep.shape
    idx = ((rays[:, None, :, :] - theirs_pos[:, :, None, :]) ** 2).sum(-1).argmin(-1)
    at = torch.gather(rays, 1, idx[..., None].expand(R, NI, 3))
    found = ((at - theirs_pos).norm(dim=-1) < 1e-4).all(-1)
    s_theirs, s_mine = torch.gather(dsum, 1, idx), torch.gather(dsum, 1, keep)
    same = ((s_theirs.sort(-1).values - s_mine.sort(-1).values).abs() <= KEEP_TIE).all(-1)
    ordered = (s_theirs[:, 1:] >= s_theirs[:, :-1] - KEEP_TIE).all(-1)
    ok = found & same & ordered
    use = torch.where(ok[:, None], idx, keep)
    return use, int((~ok & (idx != keep).any(-1)).sum())


def _follow_neighbours(samples, table_pos, live, d2, ids, r, prog_ids):
    """The compared side's neighbour ids where they tie with the
    reference's own: its live neighbours' squared distances, sorted, equal
    the reference's within ``NB_TIE`` and come in non-decreasing order
    within it.  Returns the ids to use and the count of queries where the
    compared side's differ beyond a tie."""
    pid = prog_ids.to(samples.device).long()
    dead = pid < 0
    pp = table_pos[pid.clamp(min=0)]
    dp = ((pp - samples[:, None, :]) ** 2).sum(-1)
    dp = torch.where(dead | (dp >= r * r), torch.full_like(dp, math.inf), dp)
    dr = torch.where(d2 < r, d2 * d2, torch.full_like(d2, math.inf))
    ds = dp.sort(-1).values
    same = ((torch.isinf(ds) & torch.isinf(dr)) | ((ds - dr).abs() <= NB_TIE)).all(-1)
    fin = torch.where(torch.isinf(dp), torch.full_like(dp, 1e9), dp)
    ordered = (fin[:, 1:] >= fin[:, :-1] - NB_TIE).all(-1)
    ok = same & ordered
    mine = torch.where(d2 < r, live[ids], torch.full_like(ids, -1))
    theirs = torch.where(torch.isinf(dp), torch.full_like(pid, -1), pid)
    use = torch.where(ok[:, None], theirs, mine)
    return use, int((~ok & (theirs != mine).any(-1)).sum())


def render_view(p: Dict, f, t: Dict, cam: torch.Tensor, heading: float, prec: Precision,
                follow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One novel view from a level habitat camera: ``(features [R, D],
    first kept sample per ray [R, 3], depth [R])``, the counts of rays
    whose kept samples, and of kept samples whose neighbours, differ from
    ``follow`` (the compared side's kept samples ``[R*NI, 3]`` in their
    order and their neighbour ids ``[R*NI, K]``) beyond a tie, and this
    view's own kept samples and neighbour ids."""
    H, W, NS, NI, K = f.view_height, f.view_width, f.n_samples, f.n_importance, f.search_num
    r = f.search_radius
    dev = cam.device
    R = H * W
    tx, tz = P.tangents(H, W, f.view_hfov, f.view_vfov, dev)
    dist = torch.linspace(f.near, f.far, NS, dtype=torch.float64).float().to(dev)
    rx, ry, rz = tx[:, None] * dist, dist.expand(R, NS), tz[:, None] * dist
    c, s = math.cos(heading), math.sin(heading)
    rays = torch.stack([rx * c - ry * s + cam[0], rx * s + ry * c + cam[1], rz + cam[2]], -1)
    ray_dir = -torch.atan(tx)

    live = torch.nonzero(t["patch_valid"]).flatten()
    pts = t["patch_pos"][live]
    with torch.no_grad():
        d1, _ = knn(rays.reshape(-1, 3), pts, K)
        dsum = d1.clamp(max=r).sum(-1).reshape(R, NS)
        proxy = 1.0 / dsum.clamp(min=1e-9)
        keep = torch.sort(proxy, dim=1, descending=True, stable=True).indices[:, :NI]
        kept_off = 0
        if follow is not None and tuple(follow[0].shape) == (R * NI, 3):
            keep, kept_off = _follow_kept(rays, dsum, keep, follow[0].to(dev).reshape(R, NI, 3))
    samples = torch.gather(rays, 1, keep[..., None].expand(R, NI, 3))
    d2, j = knn(samples.reshape(-1, 3), pts, K)
    nb_off = 0
    if follow is not None and tuple(follow[0].shape) == (R * NI, 3) and \
            float((follow[0].to(dev) - samples.reshape(-1, 3)).abs().max()) < 1e-4:
        use, nb_off = _follow_neighbours(samples.reshape(-1, 3), t["patch_pos"], live, d2, j, r,
                                         follow[1])
    else:
        use = torch.where(d2 < r, live[j], torch.full_like(j, -1))
    ok = (use >= 0).reshape(R, NI, K)
    ids = use.clamp(min=0).reshape(R, NI, K)
    rel = t["patch_pos"][ids] - samples[:, :, None, :]
    cm, sm = math.cos(-heading), math.sin(-heading)
    rel = torch.stack([rel[..., 0] * cm - rel[..., 1] * sm, rel[..., 0] * sm + rel[..., 1] * cm,
                       rel[..., 2]], -1)
    rel = torch.where(ok[..., None], rel, torch.full_like(rel, f.far))
    dd = t["patch_dir"][ids] - heading - ray_dir[:, None, None]
    sc = torch.where(ok[..., None], torch.stack([torch.sin(dd), torch.cos(dd)], -1),
                     torch.zeros(R, NI, K, 2, device=dev))
    scale = torch.where(ok, t["patch_scale"][ids], torch.zeros_like(dd))[..., None]
    nb = torch.where(ok[..., None], t["patch_fts"][ids].float(), torch.zeros((), device=dev))
    pe = _ln(p["pos_ln"], torch.cat([rel, sc, scale], -1) @ p["pos_w"] + p["pos_b"], 1e-12)
    fused = (nb + pe).reshape(R * NI, K * nb.shape[-1])
    agg = _ln(p["agg_ln"], fused @ p["agg_w"] + p["agg_b"], 1e-12)
    feat, dens = nerf_mlp(p["mlp"], agg, prec.mlp)

    # compositing over the whole sample grid, density at the kept samples
    sp = F.softplus(dens).reshape(R, NI)
    sigma = torch.zeros(R, NS, device=dev).scatter(1, keep, sp)
    gaps = torch.cat([dist[1:] - dist[:-1], torch.full((1,), 1e10, device=dev)])
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * gaps)
    trans = torch.cumprod(torch.cat([torch.ones(R, 1, device=dev), 1.0 - alpha + 1e-10], 1),
                          1)[:, :-1]
    wts = alpha * trans
    fmap = (torch.gather(wts, 1, keep)[..., None] * feat.reshape(R, NI, -1)).sum(1)
    fmap = fmap / fmap.norm(dim=-1, keepdim=True).clamp(min=1e-7)
    depth = (wts * dist).sum(-1) / wts.sum(-1).clamp(min=1e-7)
    return (fmap, samples[:, 0], depth, {"neighbours_off": nb_off, "samples_off": kept_off},
            (samples.reshape(-1, 3).detach(), use))


# --- the losses ---------------------------------------------------------------

def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + 1e-5)


def cosine(a, b, mask) -> torch.Tensor:
    c = (l2n(a) * l2n(b)).sum(-1)
    return ((1.0 - c) * mask).sum() / mask.sum().clamp(min=1)


def infonce(a, b, mask) -> torch.Tensor:
    """Both directions of the diagonal InfoNCE over the masked rows alone."""
    i = torch.nonzero(mask).flatten()
    if i.numel() == 0:
        return a.sum() * 0.0
    sim = LOGIT_SCALE * (l2n(a[i]) @ l2n(b[i]).T)
    y = torch.arange(i.numel(), device=a.device)
    return F.cross_entropy(sim, y) + F.cross_entropy(sim.T, y)


def hardest(logits, target, mask, rate: float = 0.1) -> torch.Tensor:
    """The rows of the focal loss's ``max(int(rate n), 1)`` largest cross
    entropies among the ``n`` masked ones, hardest first."""
    i = torch.nonzero(mask).flatten()
    ce = F.cross_entropy(logits[i].detach(), target[i], reduction="none")
    k = max(int(rate * i.numel()), 1)
    return i[torch.sort(ce, descending=True, stable=True).indices[:k]]


def focal(logits, target, mask, follow: Optional[torch.Tensor] = None, rate: float = 0.1):
    """Mean cross entropy of the masked rows plus the mean of the hardest
    ``max(int(rate n), 1)``, whether the hardest rows differ from
    ``follow`` (the compared side's, :func:`hardest` of its logits) beyond
    a tie of ``FOCAL_TIE`` (else the compared side's are taken), and the
    rows taken."""
    i = torch.nonzero(mask).flatten()
    if i.numel() == 0:
        return logits.sum() * 0.0, False, i
    ce = F.cross_entropy(logits, target, reduction="none")
    top = hardest(logits, target, mask, rate)
    off = False
    if follow is not None and follow.numel() == top.numel():
        theirs = follow.to(top.device)
        tie = bool(mask[theirs].all()) and float(
            (ce[theirs].detach().sort().values - ce[top].detach().sort().values).abs().max()
        ) <= FOCAL_TIE
        off = not tie and set(theirs.tolist()) != set(top.tolist())
        top = theirs if tie else top
    return ce[i].mean() + ce[top].mean(), off, top


def merge_ce(logit, target, valid) -> torch.Tensor:
    """The mean of the two classes' mean logistic losses (0 if one is empty)."""
    pos, neg = valid & (target == 1), valid & (target == 0)
    if not bool(pos.any()) or not bool(neg.any()):
        return logit.sum() * 0.0
    return 0.5 * (F.softplus(-logit[pos]).mean() + F.softplus(logit[neg]).mean())


def losses(cfg, b: Dict, aux: Dict, renders, sup: Dict, gt: Dict, use_labels: bool,
           follow_hard: Optional[torch.Tensor] = None):
    """The loss family over the stacked per-view byproducts ``aux`` and the
    rendered views; ``follow_hard``: the compared side's hardest rays of
    the category focal loss (:func:`focal`).  Returns the losses, whether
    the hardest rays differ beyond a tie, and the rays taken."""
    f = cfg.fields
    D = f.fts_dim
    act = aux["seg_active"].reshape(-1)
    seg = aux["seg_fts"].reshape(-1, D)
    tgt = aux["target"].reshape(-1, D)
    pm = aux["patch_mean"].repeat_interleave(f.max_segments, 0)
    zp, cls = aux["zone_pred"], b["cls"]
    allv = torch.ones(zp.shape[0], dtype=torch.bool, device=zp.device)
    sim = (infonce(seg, tgt, act) / 5 + cosine(seg, tgt, act) + cosine(seg - pm, tgt - pm, act)
           + infonce(zp, cls, allv) / 5 + cosine(zp, cls, allv)
           + cosine(zp - cls.mean(0), cls - cls.mean(0), allv))
    mvalid = aux["merge_valid"].reshape(-1) & use_labels
    segm = merge_ce(aux["merge_logit"].reshape(-1), aux["merge_target"].reshape(-1), mvalid)

    nv = torch.stack([r[0] for r in renders])                           # [Nv, R, D]
    gtf = b["novel_gt"]
    rays = torch.ones(nv.shape[0] * nv.shape[1], dtype=torch.bool, device=nv.device)
    pred, g = nv.reshape(-1, D), gtf.reshape(-1, D)
    render = (2 * cosine((nv - nv.mean(1, keepdim=True)).reshape(-1, D),
                         (gtf - gtf.mean(1, keepdim=True)).reshape(-1, D), rays)
              + 5 * cosine(pred, g, rays) + infonce(pred, g, rays) / 5)

    cat, to_cat = sup["cat"], sup["gtid_to_cat"]
    L = to_cat.shape[0]
    pos = torch.cat([r[1] for r in renders])
    xyz, lab = gt["xyz"][gt["valid"]], gt["label"][gt["valid"]]
    dnn, jnn = knn(pos, xyz, 1)
    ray_gt = lab[jnn[:, 0]].long()
    ray_cat = to_cat[ray_gt.clamp(0, L - 1)].long()
    ok = (dnn[:, 0] < f.search_radius) & (ray_gt > 0) & (ray_cat >= 0) & use_labels
    lang, hard_off, hard = focal(LOGIT_SCALE * (l2n(pred) @ cat.T), ray_cat.clamp(min=0), ok,
                                 follow_hard)
    lang = lang / 10

    ip, igt = aux["inst_pred"].reshape(-1, D), aux["inst_gt"].reshape(-1)
    text_fts, text_ok = sup["text"], sup["text_valid"]
    iok = (igt >= 0) & act & use_labels
    icat = to_cat[igt.clamp(0, L - 1)].long()
    cok = iok & (icat >= 0)
    text = focal_free_ce(LOGIT_SCALE * (l2n(ip) @ cat.T), icat.clamp(min=0), cok) / 10
    it = igt.clamp(0, text_fts.shape[0] - 1)
    text = text + infonce(ip, text_fts[it], iok & text_ok[it]) / 5
    zgt = aux["zone_gt"].reshape(-1)
    zt = zgt.clamp(0, text_fts.shape[0] - 1)
    zok = aux["zone_touch"].reshape(-1) & (zgt >= 0) & use_labels & text_ok[zt]
    text = text + infonce(aux["zone_pred_zone"].reshape(-1, D), text_fts[zt], zok) / 5
    out = {"sim_loss": sim, "segm_loss": segm, "render_loss": render, "lang_loss": lang,
           "text_loss": text}
    out["loss"] = sim + segm + render + lang + text
    return out, hard_off, hard


def focal_free_ce(logits, target, mask) -> torch.Tensor:
    """The mean cross entropy of the masked rows (0 with none)."""
    i = torch.nonzero(mask).flatten()
    if i.numel() == 0:
        return logits.sum() * 0.0
    return F.cross_entropy(logits[i], target[i])


# --- the optimizer ------------------------------------------------------------

def adamw(grads: List[torch.Tensor], state: Dict, params: List[torch.Tensor], hp: Dict,
          skip: bool = False):
    """AdamW with decoupled weight decay over already clipped gradients:
    ``(new parameters, new state)``; ``skip`` keeps the parameters and
    still advances the state."""
    n = state["count"] + 1
    b1, b2 = hp["b1"], hp["b2"]
    new_p, mus, nus = [], [], []
    for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        u = (mu / (1 - b1 ** n)) / (torch.sqrt(nu / (1 - b2 ** n)) + hp["eps"])
        new_p.append(p if skip else p + (-hp["lr"] * (u + hp["wd"] * p)))
        mus.append(mu)
        nus.append(nu)
    return new_p, {"count": n, "mu": mus, "nu": nus}


def hyper(cfg, optimizer: Dict) -> Dict[str, float]:
    """The step's optimizer constants: the learning rate and the clip from
    the model's ``train`` section, AdamW's from the configuration's
    ``optimizer`` object."""
    t = cfg.train
    return {"lr": float(t.pretrain_lr), "clip": float(t.grad_clip_value),
            "wd": float(optimizer["weight_decay"]), "b1": float(optimizer["b1"]),
            "b2": float(optimizer["b2"]), "eps": float(optimizer["eps"])}


# --- one step -----------------------------------------------------------------

def step(params: Dict, cfg, scene: Dict, sup: Dict, hp: Dict, opt_state: Optional[Dict] = None,
         *, follow: Optional[Dict] = None, low: bool = False, grad_by_view: bool = True,
         max_label: int = 512, device=None) -> Dict[str, Any]:
    """One pretraining step on ``scene``.  ``params``: ``clip``, ``fields``,
    ``render``; ``sup``: ``cat`` ``[C, D]``, ``gtid_to_cat`` ``[L]``,
    ``text`` ``[L, D]``, ``text_valid`` ``[L]``; ``hp``: :func:`hyper`;
    ``opt_state``: ``count``,
    ``mu``, ``nu`` (lists in :func:`leaves` order of ``{fields, render}``),
    ``None`` for no update.  ``follow``: the compared side's ``segm [V,
    HW]``, per view ``is_merge`` / ``owner`` ``[V, S]``, and per novel view
    ``neighbours``: the kept samples and their neighbour ids.  Returns the
    batch, the folded table, the stacked byproducts, the renders, each
    loss, the clipped gradients, the new parameters and state, and the
    discrete choices with the disagreements counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f = cfg.fields
    dev = torch.device(device) if device is not None else params["fields"]["p2i_agg_token"].device
    prec = Precision(cfg, low)
    with torch.no_grad():
        b = build(params, cfg, scene, dev)
    V = b["grid"].shape[0]
    segm_own = b["segm"]
    segm_off = 0
    if follow is not None and tuple(follow["segm"].shape) == tuple(segm_own.shape):
        theirs = follow["segm"].to(dev).long()
        segm_off = int((same_segment(theirs, f) != same_segment(segm_own, f)).sum())
        b["segm"] = theirs
    gt = {"xyz": torch.as_tensor(np.asarray(scene["gt_xyz"], np.float32), device=dev),
          "label": torch.as_tensor(np.asarray(scene["gt_label"]), device=dev).long(),
          "max_label": max_label}
    gt["valid"] = torch.ones(gt["xyz"].shape[0], dtype=torch.bool, device=dev)
    use_labels = bool(scene.get("use_labels", True))
    sup_t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in sup.items()}
    sup_t["cat"], sup_t["text"] = sup_t["cat"].float(), sup_t["text"].float()
    sup_t["text_valid"] = sup_t["text_valid"].bool()

    tr = {"fields": params["fields"], "render": params["render"]}
    named = leaves(tr)
    xs = [{"depth": b["depth"][v], "grid": b["grid"][v], "segm": b["segm"][v],
           "cam": b["cams"][v], "heading": b["headings"][v]} for v in range(V)]
    fol = None
    if follow is not None and follow["is_merge"].shape[0] == V:
        fol = [{"is_merge": follow["is_merge"][v].tolist(), "owner": follow["owner"][v].tolist()}
               for v in range(V)]

    def fold_all(pf, with_grad: bool):
        t, auxes, pres, notes = empty_table(f, dev), [], [], []
        with torch.set_grad_enabled(with_grad):
            for v in range(V):
                pres.append(t)
                t, aux, note = fold_view(pf, t, f, prec, xs[v], gt, fol[v] if fol else None)
                auxes.append(aux)
                notes.append(note)
        return t, auxes, pres, notes

    lv = [p.detach().clone().requires_grad_(True) for _, p in named]
    tr_g = rebuild(tr, lv)
    if grad_by_view:
        table, auxes, pres, notes = fold_all(tr_g["fields"], False)
        held = [{k: (a.detach().requires_grad_(True) if a.is_floating_point() else a)
                 for k, a in aux.items()} for aux in auxes]
    else:
        table, auxes, pres, notes = fold_all(tr_g["fields"], True)
        held = auxes
    stacked = {k: torch.stack([a[k] for a in held]) for k in held[0]}
    nbs = (follow or {}).get("neighbours") or [None] * len(b["novel"])
    renders = [render_view(tr_g["render"], f, table, cam, hd, prec, nb)
               for (cam, hd), nb in zip(b["novel"], nbs)]
    ls, hard_off, hard_rows = losses(cfg, b, stacked, renders, sup_t, gt, use_labels,
                                     (follow or {}).get("hardest"))
    if grad_by_view:
        keys = [k for k in held[0] if held[0][k].requires_grad]
        ins = [a[k] for a in held for k in keys]
        got = torch.autograd.grad(ls["loss"], lv + ins, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(got[: len(lv)], lv)]
        g_aux = got[len(lv):]
        fl = [(n, p) for (n, _), p in zip(named, lv) if n.startswith("fields/")]
        for v in range(V):
            with torch.enable_grad():
                _, aux_v, _ = fold_view(tr_g["fields"], pres[v], f, prec, xs[v], gt,
                                        decide=notes[v]["taken"])
            outs, gs = [], []
            for j, k in enumerate(keys):
                g = g_aux[v * len(keys) + j]
                if g is not None and aux_v[k].requires_grad:
                    outs.append(aux_v[k])
                    gs.append(g)
            if outs:
                part = torch.autograd.grad(outs, [p for _, p in fl], gs, allow_unused=True)
                for (n, p), gp in zip(fl, part):
                    if gp is not None:
                        i = next(i for i, (m, _) in enumerate(named) if m == n)
                        grads[i] = grads[i] + gp
    else:
        got = torch.autograd.grad(ls["loss"], lv, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(got, lv)]
    raw = [torch.nan_to_num(g, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
           for g in grads]
    clipped = [g.clamp(-hp["clip"], hp["clip"]) for g in raw]
    out = {"batch": b, "segm_own": segm_own, "table": table,
           "aux": {k: v.detach() for k, v in stacked.items()},
           "renders": [tuple(x.detach() for x in r[:3]) for r in renders],
           "losses": {k: float(v.detach()) for k, v in ls.items()},
           "names": [n for n, _ in named], "grads": [g.detach() for g in clipped],
           "raw_grad_max": max(float(g.abs().max()) for g in raw),
           "segm_off": segm_off, "segm_pairs": int(same_segment(segm_own, f).numel()),
           "hardest_off": float(hard_off), "hardest": hard_rows,
           "merges_off": sum(n["merges_off"] for n in notes),
           "neighbours_off": sum(r[3]["neighbours_off"] for r in renders),
           "samples_off": sum(r[3]["samples_off"] for r in renders),
           "neighbours": [r[4] for r in renders],
           "queries": sum(int(r[0].shape[0]) * f.n_importance for r in renders),
           "rays": sum(int(r[0].shape[0]) for r in renders),
           "segments": sum(n["segments"] for n in notes)}
    if opt_state is not None:
        skip = math.isnan(out["losses"]["loss"])
        out["params"], out["opt"] = adamw(out["grads"], opt_state, [p for _, p in named], hp,
                                          skip)
    return out
