"""3DFF pretraining losses over validity masks; port of
``runtime/losses_3dff.py``: cosine alignment and its subspace variant,
bidirectional InfoNCE (logit scale 10), the category focal loss (CE mean
plus the mean of the hardest ``max(int(0.1 N), 1)``) and the class-balanced
merge-discriminator CE."""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
NEG = torch.finfo(torch.float32).min


def l2n(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def cosine_loss(pred: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over ``mask`` of ``1 - cos(pred, tgt)``."""
    c = (l2n(pred) * l2n(tgt)).sum(-1)
    return ((1.0 - c) * mask).sum() / _count(mask)


def subspace_cosine_loss(pred, tgt, pred_mean, tgt_mean, mask) -> torch.Tensor:
    """Cosine loss after subtracting the per-view means."""
    return cosine_loss(pred - pred_mean, tgt - tgt_mean, mask)


def contrastive_loss(f1: torch.Tensor, f2: torch.Tensor, mask: torch.Tensor,
                     logit_scale: float = 10.0) -> torch.Tensor:
    """Bidirectional diagonal InfoNCE; masked rows and columns leave both
    the softmax and the mean (the float32-min fill of the reference)."""
    sim = logit_scale * (l2n(f1) @ l2n(f2).T)

    def nce(s: torch.Tensor) -> torch.Tensor:
        s = torch.where((s <= NEG / 2).all(dim=-1, keepdim=True), torch.zeros_like(s), s)
        lp = F.log_softmax(s, dim=-1)
        diag = torch.where(mask, torch.diagonal(lp), torch.zeros_like(lp[:, 0]))
        return -diag.sum() / _count(mask)

    neg = torch.full_like(sim, NEG)
    return nce(torch.where(mask[None, :], sim, neg)) + nce(torch.where(mask[None, :], sim.T, neg))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
               focal_rate: float = 0.1) -> torch.Tensor:
    """CE mean + mean of the ``max(int(rate * n), 1)`` hardest (a -1
    sentinel keeps the masked rows out of the top)."""
    lp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(lp, -1, torch.clamp(targets, min=0).to(torch.int64)[..., None])[..., 0]
    ce = torch.where(mask, ce, torch.zeros_like(ce))
    n = mask.to(torch.float32).sum()
    mean = ce.sum() / torch.clamp(n, min=1.0)
    k_dyn = torch.clamp((focal_rate * n).to(torch.int32), min=1)
    sorted_ce = torch.sort(torch.where(mask, ce, torch.full_like(ce, -1.0))).values.flip(0)
    in_topk = (torch.arange(ce.shape[0], device=ce.device) < k_dyn) & (sorted_ce >= 0)
    topk_mean = torch.where(in_topk, sorted_ce, torch.zeros_like(sorted_ce)).sum() \
        / torch.clamp(in_topk.sum(), min=1)
    return torch.where(n > 0, mean + topk_mean, torch.zeros_like(mean))


def balanced_merge_ce(merge_logit: torch.Tensor, target: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Class-balanced CE of the merge margin: the mean of the per-class
    means, 0 when a class is empty."""
    t = target.to(torch.float32)
    v = valid.to(torch.float32)
    n_true = (t * v).sum()
    n_false = ((1 - t) * v).sum()
    ce = torch.logaddexp(torch.zeros((), device=merge_logit.device),
                         torch.where(target == 1, -merge_logit, merge_logit))
    true_mean = (ce * t * v).sum() / torch.clamp(n_true, min=1.0)
    false_mean = (ce * (1 - t) * v).sum() / torch.clamp(n_false, min=1.0)
    return torch.where(torch.minimum(n_true, n_false) > 0, 0.5 * (true_mean + false_mean),
                       torch.zeros_like(true_mean))
