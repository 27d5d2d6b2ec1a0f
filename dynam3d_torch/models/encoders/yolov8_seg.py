"""FastSAM (YOLOv8-seg) inference; port of ``models/encoders/yolov8_seg.py``.

A CSPDarknet/C2f backbone, PAN neck, decoupled Detect head with DFL box
regression and a Segment head with prototype masks, then the reference's
static-shape postprocess: top-``pre_topk`` by score, greedy NMS over a fixed
candidate set with a validity mask, and the ``get_patch_segm`` id map
(masks overlaid in index order, nearest-downsampled to the patch grid,
renumbered consecutively).  No Pallas kernel: stock torch ops.

Layout.  The reference keeps activations NHWC and weights HWIO.  The port
keeps weights OIHW and activations NCHW, the layout of
``torch.nn.functional.conv2d``: weights are made OIHW by
:func:`init_yolov8_params` and converted once by
``convert.params_from_jax`` (the ``yolo`` subtree), and activations change
layout twice per call, inside :func:`forward` (the NHWC input in, the NHWC
prototypes out).  The public functions take and return the reference's
layouts.  Convolutions run in float32; on the card ``pin_full_fp32`` keeps
cuDNN off TF32.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.models.encoders.clip import resize_weights

Params = Dict[str, Any]

REG_MAX = 16  # DFL bins


# --------------------------------------------------------------------------
# building blocks (NCHW activations, OIHW weights)
# --------------------------------------------------------------------------
def _conv(p: Params, x: torch.Tensor, stride: int = 1, act: bool = True) -> torch.Tensor:
    """Conv2d(+folded BN) + SiLU."""
    k = p["w"].shape[-1]
    y = F.conv2d(x, p["w"], p["b"], stride=stride, padding=(k - 1) // 2)
    return F.silu(y) if act else y


def _bottleneck(p: Params, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    y = _conv(p["cv2"], _conv(p["cv1"], x))
    return x + y if shortcut else y


def _c2f(p: Params, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
    outs = list(_conv(p["cv1"], x).chunk(2, dim=1))
    for bp in p["m"]:
        outs.append(_bottleneck(bp, outs[-1], shortcut))
    return _conv(p["cv2"], torch.cat(outs, dim=1))


def _sppf(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Three chained 5x5 stride-1 max pools over -inf padding (the
    reference's "SAME" ``reduce_window``)."""
    pools = [_conv(p["cv1"], x)]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], kernel_size=5, stride=1, padding=2))
    return _conv(p["cv2"], torch.cat(pools, dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
def channels(width: float, max_ch: int = 512) -> List[int]:
    base = [64, 128, 256, 512, max_ch]
    return [max(16, int(round(c * width / 16)) * 16) if c * width >= 16 else int(c * width)
            for c in base]


class SegOutput(NamedTuple):
    boxes: torch.Tensor     # [B,A,4] xyxy (input-pixel coords)
    scores: torch.Tensor    # [B,A]
    coeffs: torch.Tensor    # [B,A,np] mask coefficients
    protos: torch.Tensor    # [B,Hp,Wp,np] prototype masks (input/4)


def forward(p: Params, x: torch.Tensor, depth_n: Sequence[int] = (3, 6, 6, 3)) -> SegOutput:
    """Full backbone+neck+heads.  ``x``: normalized ``[B,H,W,3]`` in [0,1]."""
    del depth_n    # the block counts are the lengths of the parameter lists
    x = x.permute(0, 3, 1, 2).contiguous()
    x = _conv(p["stem"], x, 2)                     # P1/2
    x = _conv(p["down1"], x, 2)                    # P2/4
    x = _c2f(p["c2f1"], x, True)
    x = _conv(p["down2"], x, 2)                    # P3/8
    p3 = _c2f(p["c2f2"], x, True)
    x = _conv(p["down3"], p3, 2)                   # P4/16
    p4 = _c2f(p["c2f3"], x, True)
    x = _conv(p["down4"], p4, 2)                   # P5/32
    x = _c2f(p["c2f4"], x, True)
    p5 = _sppf(p["sppf"], x)

    # PAN neck
    n_p4 = _c2f(p["neck1"], torch.cat([_upsample2(p5), p4], dim=1), False)
    n_p3 = _c2f(p["neck2"], torch.cat([_upsample2(n_p4), p3], dim=1), False)
    d = _conv(p["pan1"], n_p3, 2)
    n_p4b = _c2f(p["neck3"], torch.cat([d, n_p4], dim=1), False)
    d = _conv(p["pan2"], n_p4b, 2)
    n_p5 = _c2f(p["neck4"], torch.cat([d, p5], dim=1), False)

    # prototypes from P3
    pr = _upsample2(_conv(p["proto"]["cv1"], n_p3))
    pr = _conv(p["proto"]["cv2"], pr)
    protos = _conv(p["proto"]["cv3"], pr, act=False)          # [B,np,H/4,W/4]

    boxes_all, scores_all, coeffs_all = [], [], []
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
    for i, (f, s) in enumerate(zip((n_p3, n_p4b, n_p5), (8, 16, 32))):
        B, _, H, W = f.shape
        det = p["det"][i]

        def head(name):
            h = _conv(det[f"{name}1"], _conv(det[f"{name}0"], f))
            return _conv(det[f"{name}2"], h, act=False)

        box, cls, mc = head("box"), head("cls"), head("m")
        # DFL: softmax expectation over REG_MAX bins per side (l,t,r,b)
        d4 = box.reshape(B, 4, REG_MAX, H * W).permute(0, 3, 1, 2)
        dist = (torch.softmax(d4, dim=-1) * bins).sum(dim=-1)   # [B,HW,4], stride units
        cx = (torch.arange(W, dtype=torch.float32, device=x.device) + 0.5)[None, :]
        cy = (torch.arange(H, dtype=torch.float32, device=x.device) + 0.5)[:, None]
        cxg = cx.expand(H, W).reshape(-1)
        cyg = cy.expand(H, W).reshape(-1)
        x1 = (cxg[None] - dist[..., 0]) * s
        y1 = (cyg[None] - dist[..., 1]) * s
        x2 = (cxg[None] + dist[..., 2]) * s
        y2 = (cyg[None] + dist[..., 3]) * s
        boxes_all.append(torch.stack([x1, y1, x2, y2], dim=-1))
        scores_all.append(torch.sigmoid(cls.reshape(B, H * W)))
        coeffs_all.append(mc.reshape(B, mc.shape[1], H * W).transpose(1, 2))

    return SegOutput(
        boxes=torch.cat(boxes_all, dim=1),
        scores=torch.cat(scores_all, dim=1),
        coeffs=torch.cat(coeffs_all, dim=1),
        protos=protos.permute(0, 2, 3, 1).contiguous(),
    )


# --------------------------------------------------------------------------
# postprocess: fixed-capacity NMS + mask composition (batched over images,
# as the reference's vmap)
# --------------------------------------------------------------------------
def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """``[..., P, 4]`` -> ``[..., P, P]``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    return inter / (area[..., :, None] + area[..., None, :] - inter).clamp(min=1e-9)


def nms_select(
    boxes: torch.Tensor, scores: torch.Tensor, conf: float, iou_thr: float,
    max_masks: int, pre_topk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes: top-``pre_topk`` by score, suppress by
    IoU, keep <= max_masks.  ``boxes [..., A, 4]``, ``scores [..., A]``;
    returns (indices into A, keep_mask), ``[..., min(max_masks, pre_topk)]``.

    The top-k is a stable descending sort (``lax.top_k`` puts the lower
    index first among equal scores, and the greedy order depends on it).
    The greedy loop runs ``pre_topk`` steps on the device, one candidate
    per step, five launches each."""
    lead = scores.shape[:-1]
    boxes = boxes.reshape(-1, *boxes.shape[-2:])
    scores = scores.reshape(-1, scores.shape[-1])
    P = min(pre_topk, scores.shape[-1])
    sc = torch.where(scores >= conf, scores, torch.full_like(scores, -1.0))
    top_sc, top_idx = torch.sort(sc, dim=-1, descending=True, stable=True)
    top_sc, top_idx = top_sc[:, :P], top_idx[:, :P]
    bx = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    iou = _iou_matrix(bx)
    ar = torch.arange(P, device=scores.device)
    order_better = (top_sc[:, None, :] > top_sc[:, :, None]) | (
        (top_sc[:, None, :] == top_sc[:, :, None]) & (ar[None, :] < ar[:, None]))
    suppresses = order_better & (iou > iou_thr)        # [n, i, j]: j suppresses i if kept
    conf_ok = top_sc >= conf
    keep = torch.zeros_like(conf_ok)
    for i in range(P):
        keep[:, i] = conf_ok[:, i] & ~(keep & suppresses[:, i]).any(dim=-1)
    # cap to max_masks highest-score kept, compacted in score order
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    keep = keep & (rank < max_masks)
    sortk = torch.sort(torch.where(keep, ar, torch.full_like(ar, P)), dim=-1).values
    sortk = sortk[:, :max_masks]
    valid = sortk < P
    sortk = sortk.clamp(max=P - 1)
    idx = torch.gather(top_idx, 1, sortk)
    return idx.reshape(*lead, -1), valid.reshape(*lead, -1)


def segment_id_map(
    out: SegOutput,
    img_hw: Tuple[int, int],
    grid_hw: Tuple[int, int],
    conf: float = 0.4,
    iou_thr: float = 0.8,
    max_masks: int = 64,
) -> torch.Tensor:
    """Final FastSAM contract: ``[B, gh*gw]`` int64 patch segment ids.

    Masks at prototype resolution, cropped to their boxes, overlaid in index
    order (the largest id wins, which is the reference's last-wins since ids
    grow with the index), nearest-downsampled to the patch grid, then
    renumbered by rank among the image's sorted unique values
    (``torch.unique`` over all images at once, offset per image, and
    ``torch.searchsorted``)."""
    H, W = img_hw
    gh, gw = grid_hw
    dev = out.boxes.device
    idx, valid = nms_select(out.boxes, out.scores, conf, iou_thr, max_masks)
    bx = torch.gather(out.boxes, 1, idx[..., None].expand(-1, -1, 4))          # [B,M,4]
    cf = torch.gather(out.coeffs, 1, idx[..., None].expand(-1, -1, out.coeffs.shape[-1]))
    m = torch.sigmoid(torch.einsum("bhwc,bmc->bmhw", out.protos, cf))
    Hp, Wp = out.protos.shape[1], out.protos.shape[2]
    ys = (torch.arange(Hp, dtype=torch.float32, device=dev) + 0.5) * (H / Hp)
    xs = (torch.arange(Wp, dtype=torch.float32, device=dev) + 0.5) * (W / Wp)
    inbox = (
        (xs[None, None, None, :] >= bx[:, :, None, None, 0])
        & (xs[None, None, None, :] <= bx[:, :, None, None, 2])
        & (ys[None, None, :, None] >= bx[:, :, None, None, 1])
        & (ys[None, None, :, None] <= bx[:, :, None, None, 3])
    )
    binm = (m > 0.5) & inbox & valid[:, :, None, None]                          # [B,M,Hp,Wp]
    mid = torch.arange(1, binm.shape[1] + 1, device=dev)
    canvas = torch.where(binm, mid[None, :, None, None], 0).amax(dim=1)          # [B,Hp,Wp]
    ri = torch.floor(torch.arange(gh, dtype=torch.float32, device=dev) * (Hp / gh)).long()
    ci = torch.floor(torch.arange(gw, dtype=torch.float32, device=dev) * (Wp / gw)).long()
    small = canvas[:, ri][:, :, ci].reshape(canvas.shape[0], -1)
    span = max_masks + 1                   # canvas values are 0..max_masks
    base = torch.arange(small.shape[0], device=dev)[:, None] * span
    uniq = torch.unique(small + base, sorted=True)
    return torch.searchsorted(uniq, small + base) - torch.searchsorted(uniq, base)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, h, w, C), "bilinear")`` of ``[N, H, W, C]``:
    a triangle kernel, widened by the scale factor when it shrinks
    (antialias), over half-pixel centres; an axis of equal size is left as
    it is."""
    def tri(t):
        return (1.0 - t.abs()).clamp(min=0.0)

    if x.shape[1] != h:
        x = torch.einsum("nhwc,hy->nywc", x, resize_weights(x.shape[1], h, x.device, tri))
    if x.shape[2] != w:
        x = torch.einsum("nywc,wx->nyxc", x, resize_weights(x.shape[2], w, x.device, tri))
    return x


def segment_views(
    params: Params,
    seg_cfg,                  # config.SegmenterConfig
    rgb: torch.Tensor,        # [N,H,W,3] uint8 views
    grid_hw: Tuple[int, int],
    max_segments: int,
) -> torch.Tensor:
    """rgb views -> ``[N, gh*gw]`` int64 patch segment ids: bilinear resize
    to ``imgsz``, /255, everything-prompt inference at the config's
    conf/iou, the id map, ids clamped into the memory's id space."""
    s = seg_cfg.imgsz
    x = resize_bilinear(rgb.to(torch.float32) / 255.0, s, s)
    out = forward(params, x, depth_n=seg_cfg.depth_layers())
    ids = segment_id_map(out, (s, s), grid_hw, conf=seg_cfg.conf, iou_thr=seg_cfg.iou,
                         max_masks=seg_cfg.max_masks)
    return ids.clamp(max=max_segments - 1)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
def init_yolov8_params(
    gen: torch.Generator, width: float = 1.0, depth_n: Sequence[int] = (3, 6, 6, 3),
    num_protos: int = 32, max_ch: int = 512, device: DeviceLike = None,
) -> Params:
    """Random OIHW weights (He-normal, zero bias) on ``device`` (the card
    unless ``device="cpu"``), drawn from ``gen``, which lives there."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, parameters on {device}")
    ch = channels(width, max_ch)

    def conv(cin, cout, k=3):
        w = torch.randn((cout, cin, k, k), generator=gen, device=device)
        return {"w": w * (2.0 / (k * k * cin)) ** 0.5,
                "b": torch.zeros((cout,), device=device)}

    def c2f(cin, cout, n, e=0.5):
        hidden = int(cout * e)
        return {
            "cv1": conv(cin, 2 * hidden, 1),
            "m": [{"cv1": conv(hidden, hidden, 3), "cv2": conv(hidden, hidden, 3)}
                  for _ in range(n)],
            "cv2": conv((2 + n) * hidden, cout, 1),
        }

    c1, c2, c3, c4, c5 = ch
    n1, n2, n3, n4 = depth_n
    npr = num_protos
    p: Params = {
        "stem": conv(3, c1),
        "down1": conv(c1, c2),
        "c2f1": c2f(c2, c2, n1),
        "down2": conv(c2, c3),
        "c2f2": c2f(c3, c3, n2),
        "down3": conv(c3, c4),
        "c2f3": c2f(c4, c4, n3),
        "down4": conv(c4, c5),
        "c2f4": c2f(c5, c5, n4),
        "sppf": {"cv1": conv(c5, c5 // 2, 1), "cv2": conv(c5 * 2, c5, 1)},
        "neck1": c2f(c5 + c4, c4, n1),
        "neck2": c2f(c4 + c3, c3, n1),
        "pan1": conv(c3, c3),
        "neck3": c2f(c3 + c4, c4, n1),
        "pan2": conv(c4, c4),
        "neck4": c2f(c4 + c5, c5, n1),
        "proto": {"cv1": conv(c3, c3, 3), "cv2": conv(c3, c3, 3), "cv3": conv(c3, npr, 1)},
        "det": [],
    }
    for cf in (c3, c4, c5):
        cbox = max(16, 4 * REG_MAX)
        ccls = max(c3, 16)
        cm = max(c3 // 4, npr)
        p["det"].append({
            "box0": conv(cf, cbox), "box1": conv(cbox, cbox), "box2": conv(cbox, 4 * REG_MAX, 1),
            "cls0": conv(cf, ccls), "cls1": conv(ccls, ccls), "cls2": conv(ccls, 1, 1),
            "m0": conv(cf, cm), "m1": conv(cm, cm), "m2": conv(cm, npr, 1),
        })
    return p
