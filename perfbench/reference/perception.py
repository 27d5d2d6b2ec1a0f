"""The plain reference of the VLN policy's perception: one step's
segmentation, CLIP features, frustum forgetting, layered memory fold and
multimodal tokens, in plain PyTorch.

Written from the policy's semantics (the Dynam3D reference's
``Policy_Dynam3D_VLN`` perception half and ``Feature_Fields``), not from
the program's code: one segment, one merged instance and one zone at a
time, each aggregation over its own members and nothing padded or masked,
every product in float32.  Values take the precision the configuration
states: the CLIP towers, the projector and the memory's encoders round
their activations and weights to bf16 between operations (float32
products and sums), YOLOv8-seg, the geometry and the position MLPs stay in
float32.  Takes the weights tree and the step's inputs, reads the memory
state before the step by its field names, and imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
TOMBSTONE = -10000.0
I_ENV = Z_ENV = 64            # instance and zone token slots in the prompt
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PRE_TOPK = 256                # NMS candidates: the best by score
DEAD = 1e6                    # a merge proposal this far (squared) is no instance
KEY_EPS = 1e-4                # zone keys equal within this


class State(NamedTuple):
    """One episode's memory tables (batched: a leading batch dim)."""

    patch_pos: torch.Tensor
    patch_fts: torch.Tensor
    patch_dir: torch.Tensor
    patch_scale: torch.Tensor
    patch_owner: torch.Tensor
    patch_valid: torch.Tensor
    patch_step: torch.Tensor
    inst_pos: torch.Tensor
    inst_fts: torch.Tensor
    inst_valid: torch.Tensor
    inst_gt_id: torch.Tensor
    zone_key: torch.Tensor
    zone_pos: torch.Tensor
    zone_fts: torch.Tensor
    zone_valid: torch.Tensor


class Out(NamedTuple):
    state: State
    mm_tokens: torch.Tensor    # [B, N_mm, D_llm]
    mm_valid: torch.Tensor     # [B, N_mm]


def empty_state(f, batch: int, device) -> State:
    """The empty tables: tombstoned positions, zero features, nothing live."""
    P, I, Z, D = f.patch_capacity, f.instance_capacity, f.zone_capacity, f.fts_dim

    def full(shape, v, dt=torch.float32):
        return torch.full((batch, *shape), v, dtype=dt, device=device)

    return State(full((P, 3), TOMBSTONE), full((P, D), 0.0, BF16), full((P,), 0.0),
                 full((P,), 0.0), full((P,), -1, torch.int64), full((P,), False, torch.bool),
                 full((P,), 0, torch.int64), full((I, 3), TOMBSTONE), full((I, D), 0.0),
                 full((I,), False, torch.bool), full((I,), -1, torch.int64),
                 full((Z, 3), TOMBSTONE), full((Z, 3), TOMBSTONE), full((Z, D), 0.0),
                 full((Z,), False, torch.bool))


# --- arithmetic ---------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """``x @ w`` over values rounded to ``dt``, products and sums in float32."""
    return x.to(dt).float() @ w.to(dt).float()


def linear(p: Dict, x: torch.Tensor, dt=torch.float32) -> torch.Tensor:
    """A dense layer whose output is rounded to ``dt``."""
    return (_mm(x, p["w"], dt) + p["b"].float()).to(dt)


def norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(xf.var(-1, unbiased=False, keepdim=True)
                                                       + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def mlp2(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Linear, LayerNorm, GELU, Linear, in float32."""
    return linear(p["fc2"], gelu(norm(p["ln"], linear(p["fc1"], x.float()))))


def attention(p: Dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Full self-attention over ``x [..., T, D]`` (no mask: the caller
    passes exactly the tokens that attend to one another)."""
    dt, D = x.dtype, x.shape[-1]
    hd = D // heads
    q, k, v = linear(p["qkv"], x, dt).split(D, dim=-1)
    q, k, v = (t.reshape(*t.shape[:-1], heads, hd).transpose(-2, -3).float() for t in (q, k, v))
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1).to(dt).float()
    o = (a @ v).transpose(-2, -3).reshape(*x.shape[:-1], D).to(dt)
    return linear(p["out"], o, dt)


def encoder(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Post-norm transformer layers (GELU), then a final LayerNorm at eps
    1e-12, in bf16; heads of 64."""
    x = x.to(BF16)
    heads = max(1, x.shape[-1] // 64)
    for lp in p["layers"]:
        x = norm(lp["ln1"], x + attention(lp["attn"], x, heads))
        h = linear(lp["ff2"], gelu(linear(lp["ff1"], x, BF16)), BF16)
        x = norm(lp["ln2"], x + h)
    return norm(p["final_ln"], x, eps=1e-12)


# --- CLIP ---------------------------------------------------------------------

def clip_pixels(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 ``[N, H, W, 3]`` at the tower's size -> normalized bf16."""
    if rgb.shape[1] != size or rgb.shape[2] != size:
        raise ValueError(f"views of {tuple(rgb.shape[1:3])}, the tower takes {size}")
    mean = torch.tensor(CLIP_MEAN, device=rgb.device)
    std = torch.tensor(CLIP_STD, device=rgb.device)
    return ((rgb.float() / 255.0 - mean) / std).to(BF16)


def clip_hidden(p: Dict, c, pixels: torch.Tensor, blocks: int) -> torch.Tensor:
    """Patch embedding, CLS, positions, ``ln_pre`` and the first ``blocks``
    pre-norm blocks (QuickGELU) of the image tower: ``[N, 1 + G*G, W]``."""
    v = p["visual"]
    N, g, ps = pixels.shape[0], c.grid, c.patch_size
    patches = pixels.reshape(N, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = _mm(patches.reshape(N, g * g, ps * ps * 3), v["conv1_w"], BF16).to(BF16)
    cls = v["class_embedding"].to(BF16).expand(N, 1, -1)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(BF16)
    x = norm(v["ln_pre"], x)
    for bp in v["transformer"]["blocks"][:blocks]:
        x = x + attention(bp["attn"], norm(bp["ln1"], x), c.vision_heads)
        h = linear(bp["fc1"], norm(bp["ln2"], x), BF16).float()
        x = x + linear(bp["fc2"], (h * torch.sigmoid(1.702 * h)).to(BF16), BF16)
    return x


def clip_grid(p: Dict, c, pixels: torch.Tensor) -> torch.Tensor:
    """Every patch token through the whole tower, ``ln_post`` and the
    projection: ``[N, G*G, E]`` bf16."""
    x = clip_hidden(p, c, pixels, c.vision_layers)
    return _mm(norm(p["visual"]["ln_post"], x[:, 1:]), p["visual"]["proj"], BF16).to(BF16)


def llava_features(p: Dict, cfg, pixels: torch.Tensor) -> torch.Tensor:
    """LLaVA's tower at ``vision_feature_layer`` (CLS dropped) through the
    projector, Linear, GELU, Linear: ``[N, G*G, D_llm]`` bf16."""
    c = cfg.clip
    x = clip_hidden(p["clip"], c, pixels, c.vision_layers + cfg.llava.vision_feature_layer + 1)
    pr = p["projector"]
    return linear(pr["fc2"], gelu(linear(pr["fc1"], x[:, 1:], BF16)), BF16)


# --- YOLOv8-seg ---------------------------------------------------------------

def _conv(p: Dict, x: torch.Tensor, stride: int = 1, act: bool = True) -> torch.Tensor:
    k = p["w"].shape[-1]
    y = F.conv2d(x, p["w"].float(), p["b"].float(), stride=stride, padding=k // 2)
    return F.silu(y) if act else y


def _c2f(p: Dict, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    outs = list(_conv(p["cv1"], x).chunk(2, dim=1))
    for bp in p["m"]:
        y = _conv(bp["cv2"], _conv(bp["cv1"], outs[-1]))
        outs.append(outs[-1] + y if shortcut else y)
    return _conv(p["cv2"], torch.cat(outs, dim=1))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def yolo_forward(p: Dict, x: torch.Tensor):
    """``x [N, 3, S, S]`` in [0, 1] -> boxes ``[N, A, 4]`` (xyxy, input
    pixels), scores ``[N, A]``, mask coefficients ``[N, A, np]``, prototypes
    ``[N, np, S/4, S/4]``; anchors row-major per level, levels 8, 16, 32."""
    x = _conv(p["down1"], _conv(p["stem"], x, 2), 2)
    x = _c2f(p["c2f1"], x, True)
    p3 = _c2f(p["c2f2"], _conv(p["down2"], x, 2), True)
    p4 = _c2f(p["c2f3"], _conv(p["down3"], p3, 2), True)
    x = _c2f(p["c2f4"], _conv(p["down4"], p4, 2), True)
    y = [_conv(p["sppf"]["cv1"], x)]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, stride=1, padding=2))
    p5 = _conv(p["sppf"]["cv2"], torch.cat(y, dim=1))
    n4 = _c2f(p["neck1"], torch.cat([_up2(p5), p4], 1), False)
    n3 = _c2f(p["neck2"], torch.cat([_up2(n4), p3], 1), False)
    n4b = _c2f(p["neck3"], torch.cat([_conv(p["pan1"], n3, 2), n4], 1), False)
    n5 = _c2f(p["neck4"], torch.cat([_conv(p["pan2"], n4b, 2), p5], 1), False)
    pr = p["proto"]
    protos = _conv(pr["cv3"], _conv(pr["cv2"], _up2(_conv(pr["cv1"], n3))), act=False)

    boxes, scores, coeffs = [], [], []
    for hp, f, s in zip(p["det"], (n3, n4b, n5), (8, 16, 32)):
        N, _, H, W = f.shape

        def head(a, b, c):
            t = _conv(hp[c], _conv(hp[b], _conv(hp[a], f)), act=False)
            return t.permute(0, 2, 3, 1).reshape(N, H * W, -1)

        bins = head("box0", "box1", "box2").reshape(N, H * W, 4, -1)
        dist = (torch.softmax(bins, -1) * torch.arange(bins.shape[-1], device=f.device)).sum(-1)
        gy, gx = torch.meshgrid(torch.arange(H, device=f.device) + 0.5,
                                torch.arange(W, device=f.device) + 0.5, indexing="ij")
        cx, cy = gx.reshape(1, -1), gy.reshape(1, -1)
        boxes.append(torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                                  cx + dist[..., 2], cy + dist[..., 3]], -1) * s)
        scores.append(torch.sigmoid(head("cls0", "cls1", "cls2")[..., 0]))
        coeffs.append(head("m0", "m1", "m2"))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(coeffs, 1), protos


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of one box ``a [4]`` with boxes ``b [n, 4]``."""
    area = lambda t: (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)
    w = (torch.minimum(a[2], b[:, 2]) - torch.maximum(a[0], b[:, 0])).clamp(min=0)
    h = (torch.minimum(a[3], b[:, 3]) - torch.maximum(a[1], b[:, 1])).clamp(min=0)
    inter = w * h
    return inter / (area(a) + area(b) - inter).clamp(min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, conf: float, iou_thr: float,
        max_masks: int) -> List[int]:
    """Greedy NMS on the host: of the ``PRE_TOPK`` best scores (the lower
    anchor first among equals) those at ``conf`` or over, each kept unless
    a kept one overlaps it by more than ``iou_thr``; the first
    ``max_masks`` kept, best first."""
    order = torch.sort(scores, descending=True, stable=True).indices[:PRE_TOPK].tolist()
    kept: List[int] = []
    for i in order:
        if len(kept) == max_masks or float(scores[i]) < conf:
            break
        if not kept or not bool((_iou(boxes[i], boxes[kept]) > iou_thr).any()):
            kept.append(i)
    return kept


def segment_ids(p: Dict, seg, rgb: torch.Tensor, grid: Tuple[int, int],
                max_segments: int) -> torch.Tensor:
    """uint8 views ``[N, H, W, 3]`` -> ``[N, gh*gw]`` patch segment ids:
    the views resized (bilinear) to ``imgsz``, YOLOv8-seg's everything
    prompt, the kept masks (prototypes times coefficients over 0, cropped
    to their boxes) painted in order with the later on top, read at the
    patch grid (nearest), renumbered by rank of value, and clamped into the
    memory's segment ids."""
    S = seg.imgsz
    x = F.interpolate(rgb.permute(0, 3, 1, 2).float() / 255.0, size=(S, S), mode="bilinear",
                      align_corners=False, antialias=rgb.shape[1] > S)
    boxes, scores, coeffs, protos = yolo_forward(p, x)
    Hp, Wp = protos.shape[-2:]
    gh, gw = grid
    ys = (torch.arange(Hp, device=x.device) + 0.5) * (S / Hp)
    xs = (torch.arange(Wp, device=x.device) + 0.5) * (S / Wp)
    ri = torch.floor(torch.arange(gh, dtype=torch.float32) * (Hp / gh)).long().to(x.device)
    ci = torch.floor(torch.arange(gw, dtype=torch.float32) * (Wp / gw)).long().to(x.device)
    out = []
    for n in range(x.shape[0]):
        canvas = torch.zeros(Hp, Wp, dtype=torch.int64, device=x.device)
        for j, a in enumerate(nms(boxes[n].cpu(), scores[n].cpu(), seg.conf, seg.iou,
                                  seg.max_masks)):
            bx = boxes[n, a]
            logit = torch.einsum("chw,c->hw", protos[n], coeffs[n, a])
            inside = ((xs[None, :] >= bx[0]) & (xs[None, :] <= bx[2])
                      & (ys[:, None] >= bx[1]) & (ys[:, None] <= bx[3]))
            canvas[(torch.sigmoid(logit) > 0.5) & inside] = j + 1
        small = canvas[ri][:, ci].reshape(-1)
        out.append(torch.unique(small, return_inverse=True)[1])
    return torch.stack(out).clamp(max=max_segments - 1)


# --- geometry -----------------------------------------------------------------

def metric_depth(depth: torch.Tensor, lo: float = 0.0, hi: float = 10.0) -> torch.Tensor:
    """Normalized depth ``[..., H, W]`` -> metres; a zero pixel takes the
    largest value of its column first."""
    cmax = depth.amax(dim=-2, keepdim=True).expand_as(depth)
    return lo + torch.where(depth == 0, cmax, depth) * (hi - lo)


def nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cv2 INTER_NEAREST over the last two dims (source index in float32)."""
    ri = torch.floor(torch.arange(h, dtype=torch.float32) * (x.shape[-2] / h)).long()
    ci = torch.floor(torch.arange(w, dtype=torch.float32) * (x.shape[-1] / w)).long()
    return x[..., ri.to(x.device), :][..., ci.to(x.device)]


def tangents(h: int, w: int, hfov: float, vfov: float, device):
    """Per patch (row-major) the horizontal and vertical view tangents."""
    col = torch.tensor([i / (w // 2) + 1.0 / w for i in range(-(w // 2), w // 2)],
                       dtype=torch.float32) * math.tan(math.pi * hfov / 360.0)
    row = torch.tensor([i / (h // 2) - 1.0 / h for i in range(h // 2, -(h // 2), -1)],
                       dtype=torch.float32) * math.tan(math.pi * vfov / 360.0)
    return col.repeat(h).to(device), row.repeat_interleave(w).to(device)


def to_world(p: torch.Tensor) -> torch.Tensor:
    """Habitat (x, y up, z) -> world (x, -z, y)."""
    return torch.stack([p[..., 0], -p[..., 2], p[..., 1]], -1)


def rotate_into(pos: torch.Tensor, cam: torch.Tensor, heading) -> torch.Tensor:
    """World points into the agent's heading frame (x, forward, up)."""
    d = pos - cam
    c, s = math.cos(-heading), math.sin(-heading)
    return torch.stack([d[:, 0] * c - d[:, 1] * s, d[:, 0] * s + d[:, 1] * c, d[:, 2]], -1)


def zone_cell(pos: torch.Tensor, f) -> torch.Tensor:
    size = torch.tensor([f.zone_x_length, f.zone_y_length, f.zone_z_length],
                        dtype=torch.float32, device=pos.device)
    return torch.floor(pos / size) * size + size / 2


# --- the memory ---------------------------------------------------------------

def _tables(st: State) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in st._asdict().items()}


def forget(t: Dict, f, depth: torch.Tensor, cam: torch.Tensor, heading: float) -> None:
    """Tombstone the live patches the view sees (inside its frustum up to
    ``deleted_frustum_distance`` and no deeper than its depth map plus the
    slack), then the touched instances left with no patch, then the zones
    of those instances' cells left with no instance.  ``depth [H, W]``."""
    H, W = depth.shape
    fx = W / math.tan(math.radians(f.input_hfov) / 2.0) / 2.0
    fy = H / math.tan(math.radians(f.input_vfov) / 2.0) / 2.0
    r = rotate_into(t["patch_pos"], cam, heading)
    z = r[:, 1]
    u = torch.trunc((fx * r[:, 0] + W / 2.0 * z) / z)
    v = torch.trunc((fy * -r[:, 2] + H / 2.0 * z) / z)
    inside = (z >= 0.0) & (z <= f.deleted_frustum_distance) & (u >= 0) & (u <= W - 1) \
        & (v >= 0) & (v <= H - 1)
    seen = depth[v.clamp(0, H - 1).long(), u.clamp(0, W - 1).long()]
    gone = inside & (z < seen + f.frustum_depth_slack) & t["patch_valid"]

    touched = torch.zeros_like(t["inst_valid"])
    touched[t["patch_owner"][gone & (t["patch_owner"] >= 0)]] = True
    t["patch_valid"] = t["patch_valid"] & ~gone
    t["patch_pos"][gone] = TOMBSTONE
    t["patch_fts"][gone] = 0
    t["patch_dir"][gone] = 0.0
    t["patch_scale"][gone] = 0.0
    t["patch_owner"][gone] = -1
    owned = torch.zeros_like(t["inst_valid"])
    live_own = t["patch_owner"][t["patch_valid"] & (t["patch_owner"] >= 0)]
    owned[live_own] = True
    dead = t["inst_valid"] & touched & ~owned
    dead_cells = zone_cell(t["inst_pos"][dead], f)
    t["inst_valid"] = t["inst_valid"] & ~dead
    t["inst_pos"][dead] = TOMBSTONE
    t["inst_fts"][dead] = 0.0
    t["inst_gt_id"][dead] = -10000
    live_cells = zone_cell(t["inst_pos"][t["inst_valid"]], f)

    def hit(cells):
        return ((t["zone_key"][:, None] - cells[None]).abs() < KEY_EPS).all(-1).any(-1)

    gone_z = t["zone_valid"] & hit(dead_cells) & ~hit(live_cells)
    t["zone_valid"] = t["zone_valid"] & ~gone_z
    t["zone_key"][gone_z] = TOMBSTONE
    t["zone_pos"][gone_z] = TOMBSTONE
    t["zone_fts"][gone_z] = 0.0


def _embed_in(pos, center, direction, scale) -> torch.Tensor:
    """Patch -> instance position input: the offset from the centre, the
    norm of the absolute position, the direction's sine and cosine, the
    footprint."""
    return torch.cat([pos - center, pos.norm(dim=-1, keepdim=True), torch.sin(direction)[:, None],
                      torch.cos(direction)[:, None], scale[:, None]], -1)


def _aggregate(agg: torch.Tensor, enc: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """The [AGG] token's output over ``[AGG] + tokens``, float32."""
    return encoder(enc, torch.cat([agg.float(), tokens], 0))[0].float()


def _first_free(valid: torch.Tensor, n: int) -> List[int]:
    """The ``n`` smallest free slots; past the table's end the last slot."""
    free = torch.nonzero(~valid).flatten().tolist()
    return [free[i] if i < len(free) else valid.shape[0] - 1 for i in range(n)]


def fold(p: Dict, t: Dict, f, depth: torch.Tensor, grid: torch.Tensor, segm: torch.Tensor,
         cam: torch.Tensor, heading: float) -> None:
    """Fold one view into the tables: write its patches, aggregate each
    segment, merge it into the nearest of its proposals that the
    discriminator accepts or make it a new instance, re-aggregate each
    merged instance over its members, then refresh the zones of the cells
    the segments' centres fall in.  ``depth [HW]`` metres, ``grid [HW, D]``
    bf16, ``segm [HW]``."""
    H, W, S = f.input_height, f.input_width, f.max_segments
    HW, P = H * W, f.patch_capacity
    dev = depth.device
    tx, tz = tangents(H, W, f.input_hfov, f.input_vfov, dev)
    dx, dz = depth * tx, depth * tz
    c, s = math.cos(heading), math.sin(heading)
    pos = torch.stack([dx * c - depth * s, dx * s + depth * c, dz], -1) + cam
    direction = torch.remainder(-torch.atan(tx) + heading, 2 * math.pi)
    scale = depth * (math.tan(math.pi * f.input_hfov / 360.0) * 2.0 / W)

    # slots: the free ones in order, then the oldest live ones
    valid = t["patch_valid"]
    free = torch.nonzero(~valid).flatten()
    if free.numel() < HW:
        live = torch.nonzero(valid).flatten()
        age = t["patch_step"][live] * P + live
        free = torch.cat([free, live[torch.argsort(age)][: HW - free.numel()]])
    slots = torch.sort(free[:HW]).values
    stamp = int(t["patch_step"].max()) + 1
    t["patch_pos"][slots] = pos
    t["patch_fts"][slots] = grid.to(t["patch_fts"].dtype)
    t["patch_dir"][slots] = direction
    t["patch_scale"][slots] = scale
    t["patch_valid"][slots] = True
    t["patch_step"][slots] = stamp

    # each segment on its own
    segs = sorted(set(segm.tolist()))
    centers = torch.zeros(S, 3, device=dev)
    seg_fts = {}
    for sid in segs:
        m = segm == sid
        centers[sid] = pos[m].mean(0)
        tok = grid[m].float() + mlp2(p["patch_pos_mlp"], _embed_in(
            pos[m], centers[sid].expand(int(m.sum()), 3), direction[m], scale[m]))
        seg_fts[sid] = _aggregate(p["p2i_agg_token"], p["p2i_encoder"], tok)

    # proposals: the K nearest live instances of the table before the view
    K = f.num_proposal_instances
    live_i = torch.nonzero(t["inst_valid"]).flatten()
    prop = {}
    for sid in segs:
        d2 = ((t["inst_pos"][live_i] - centers[sid]) ** 2).sum(-1)
        order = torch.sort(d2, stable=True).indices[:K]
        prop[sid] = [(int(live_i[o]), float(d2[o])) for o in order]
    # a proposal rank that some segment cannot fill (or fills past DEAD)
    # is offered to none, nor is any rank after it
    ranks = next((k for k in range(K) if any(len(prop[sid]) <= k or prop[sid][k][1] >= DEAD
                                             for sid in segs)), K)
    md = p["merge_disc"]
    owner = {}
    new = []
    for sid in segs:
        target = None
        for k in range(ranks):
            i, _ = prop[sid][k]
            x = torch.cat([t["inst_fts"][i].float(), seg_fts[sid], centers[sid] - t["inst_pos"][i]])
            logit = linear(md["fc2"], gelu(norm(md["ln"], linear(md["fc1"], x))))
            if bool(logit[1] > logit[0]):
                target = i
                break
        if target is None:
            new.append(sid)
        else:
            owner[sid] = target
    for sid, slot in zip(new, _first_free(t["inst_valid"], len(new))):
        owner[sid] = slot
        t["inst_pos"][slot] = centers[sid]
        t["inst_fts"][slot] = seg_fts[sid]
        t["inst_valid"][slot] = True
    seg_owner = torch.full((S,), -1, dtype=torch.int64, device=dev)
    for sid, i in owner.items():
        seg_owner[sid] = i
    t["patch_owner"][slots] = seg_owner[segm]

    # each merged instance again, over its members (the lowest slots first)
    for i in sorted({owner[sid] for sid in segs if sid not in new}):
        mem = torch.nonzero(t["patch_valid"] & (t["patch_owner"] == i)).flatten()[: f.max_members]
        mpos = t["patch_pos"][mem]
        center = mpos.mean(0)
        tok = t["patch_fts"][mem].float() + mlp2(p["patch_pos_mlp"], _embed_in(
            mpos, center.expand_as(mpos), t["patch_dir"][mem], t["patch_scale"][mem]))
        t["inst_pos"][i] = center
        t["inst_fts"][i] = _aggregate(p["p2i_agg_token"], p["p2i_encoder"], tok)

    # zones: each cell a segment's centre falls in, in sorted order, against
    # the zone table before the view; a cell with no live instance is skipped
    cells = torch.unique(zone_cell(centers[segs], f), dim=0)
    inst_cells = zone_cell(t["inst_pos"], f)
    zvalid0, zkey0 = t["zone_valid"].clone(), t["zone_key"].clone()
    free_z = _first_free(zvalid0, cells.shape[0])
    n_new = 0
    writes = []
    for cell in cells:
        members = torch.nonzero(t["inst_valid"] & ((inst_cells - cell).abs() < KEY_EPS).all(-1)
                                ).flatten()[: f.max_zone_members]
        same = torch.nonzero(zvalid0 & ((zkey0 - cell).abs() < KEY_EPS).all(-1)).flatten()
        if members.numel() == 0:
            continue
        if same.numel():
            zid, mpos = int(same[0]), cell.expand(members.numel(), 3)
        else:
            zid, mpos = free_z[n_new], t["inst_pos"][members]
            n_new += 1
        zpos = mpos.mean(0)
        emb = torch.cat([mpos - zpos, mpos.norm(dim=-1, keepdim=True)], -1)
        tok = t["inst_fts"][members].float() + mlp2(p["inst_pos_mlp"], emb)
        writes.append((zid, cell, zpos, _aggregate(p["i2z_agg_token"], p["i2z_encoder"], tok)))
    for zid, cell, zpos, fts in writes:
        t["zone_key"][zid], t["zone_pos"][zid], t["zone_fts"][zid] = cell, zpos, fts
        t["zone_valid"][zid] = True


# --- one step -----------------------------------------------------------------

def _first_live(mask: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.nonzero(mask).flatten()[:n]
    fill = torch.arange(n, device=mask.device) < idx.numel()
    pad = torch.full((n - idx.numel(),), mask.shape[0] - 1, dtype=idx.dtype, device=mask.device)
    return torch.cat([idx, pad]), fill


def perceive(p: Dict, cfg, state, rgb: torch.Tensor, depth: torch.Tensor,
             position: torch.Tensor, heading: torch.Tensor) -> Out:
    """One step of B agents: ``rgb [B, V, Hc, Wc, 3]`` uint8, ``depth [B,
    V, Hd, Wd]`` normalized (float, or uint16 over 65535), habitat
    ``position [B, 3]`` and ``heading [B]``; ``state`` (batched) is read by
    its field names."""
    f = cfg.fields
    st = State(**{k: getattr(state, k) for k in State._fields})
    if depth.dtype == torch.uint16:
        depth = depth.float() * (1.0 / 65535.0)
    B, V = rgb.shape[:2]
    H, W = f.input_height, f.input_width
    views = rgb.reshape(B * V, *rgb.shape[2:])
    d_full = metric_depth(depth.float())                               # [B, V, Hd, Wd]
    d_grid = metric_depth(nearest(depth.float(), H, W)).reshape(B, V, H * W)
    pixels = clip_pixels(views, cfg.clip.image_size)
    grid = clip_grid(p["clip"], cfg.clip, pixels)
    grid = grid.to(torch.float16).to(BF16).reshape(B, V, H * W, -1)   # the fp16 table round
    segm = segment_ids(p["yolo"], cfg.segmenter, views, (H, W), f.max_segments).reshape(B, V, -1)
    cams = to_world(position.float())

    tables, inst_tok, zone_tok, inst_fill, zone_fill = [], [], [], [], []
    for b in range(B):
        t = _tables(State(*(x[b] for x in st)))
        h0 = float(heading[b])
        for v in range(V):           # every view culls at the agent's heading
            forget(t, f, d_full[b, v], cams[b], h0)
        for v in range(V):
            fold(p["fields"], t, f, d_grid[b, v], grid[b, v], segm[b, v], cams[b],
                 h0 - v * math.pi / 6.0)
        ir = rotate_into(t["inst_pos"], cams[b], h0)
        zr = rotate_into(t["zone_pos"], cams[b], h0)
        ii, ifill = _first_live(t["inst_valid"] & (ir.norm(dim=-1) <= cfg.eval.instance_distance),
                                I_ENV)
        zi, zfill = _first_live(t["zone_valid"] & (zr.norm(dim=-1) <= cfg.eval.zone_distance),
                                Z_ENV)
        inst_tok.append(mlp2(p["inst_proj"], torch.cat(
            [t["inst_fts"][ii].float(), mlp2(p["inst_pos_emb"], ir[ii])], -1)))
        zone_tok.append(mlp2(p["zone_proj"], torch.cat(
            [t["zone_fts"][zi].float(), mlp2(p["zone_pos_emb"], zr[zi])], -1)))
        inst_fill.append(ifill)
        zone_fill.append(zfill)
        tables.append(t)

    tower = llava_features(p["llava"], cfg, pixels)                    # [B*V, HW, D_llm]
    tx, tz = tangents(H, W, f.input_hfov, f.input_vfov, rgb.device)
    d = d_grid.reshape(B * V, H * W)
    pdir = torch.remainder(-torch.atan(tx), 2 * math.pi).expand_as(d)
    p3d = torch.stack([d * tx, d, d * tz, torch.sin(pdir), torch.cos(pdir),
                       d * (math.tan(math.pi * f.input_hfov / 360.0) * 2.0 / W)], -1)
    patch_tok = (tower.float() + mlp2(p["patch_pos_emb"], p3d)).reshape(B, V * H * W, -1)
    dt = p["llava"]["phi3"]["embed_tokens"].dtype
    mm = torch.cat([patch_tok.to(dt), torch.stack(inst_tok).to(dt), torch.stack(zone_tok).to(dt)],
                   1)
    valid = torch.cat([torch.ones(B, V * H * W, dtype=torch.bool, device=rgb.device),
                       torch.stack(inst_fill), torch.stack(zone_fill)], 1)
    state = State(*(torch.stack([t[k] for t in tables]) for k in State._fields))
    return Out(state, mm, valid)
