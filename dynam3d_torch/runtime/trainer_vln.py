"""VLN imitation-learning step; port of ``runtime/trainer_vln.py``.

The policy's five 3D-token projector trees and Phi-3 train; the feature
fields, both CLIP towers and the multimodal projector stay frozen.  A step
is perceive + teacher-forced loss + backward, NaN gradients zeroed, a clip
to global norm ``grad_clip_norm``, then Adafactor; a NaN loss leaves the
parameters and the optimizer state as they were.

:class:`Adafactor` is ``optax.adafactor(learning_rate)`` at optax 0.2.6's
defaults, written out: factored second moments for leaves whose two largest
dims are >= 128, decay ``1 - (step + 1)^-0.8``, eps 1e-30, each update
clipped to block RMS 1, scaled by the learning rate and by the parameter's
RMS (floor 1e-3), no momentum.  The update is added in float32 and rounded
to the parameter's dtype, as ``optax.apply_updates`` does: on bf16 weights
an update below half a bf16 step leaves the weight as it was (there are no
float32 master weights).

The reference's clip multiplies each gradient by a float32 scale, so its
clipped gradients, and the updates made from them, are float32 whatever
the parameter's dtype; the port does the same.  Its global norm reduces
each bf16 leaf in bf16; the port sums every leaf's squares in float32.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.models import policy as policy_mod
from dynam3d_torch.models.memory3d import FieldState
from dynam3d_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]

TRAINABLE_KEYS = ("patch_pos_emb", "inst_pos_emb", "zone_pos_emb", "inst_proj", "zone_proj")


def split_params(params: Params) -> Tuple[Params, Params]:
    """``(trainable, frozen)`` split of the policy tree; both share the
    tensors of ``params``."""
    trainable = {k: params[k] for k in TRAINABLE_KEYS}
    trainable["phi3"] = params["llava"]["phi3"]
    frozen = {k: v for k, v in params.items() if k not in TRAINABLE_KEYS}
    frozen["llava"] = {k: v for k, v in params["llava"].items() if k != "phi3"}
    return trainable, frozen


def merge_params(trainable: Params, frozen: Params) -> Params:
    merged = dict(frozen)
    for k in TRAINABLE_KEYS:
        merged[k] = trainable[k]
    merged["llava"] = dict(frozen["llava"])
    merged["llava"]["phi3"] = trainable["phi3"]
    return merged


# optax.adafactor's defaults (optax 0.2.6)
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """The two largest dims (optax's ``_factored_dims``), or None when the
    second largest is below ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """``optax.adafactor(lr)`` with optax 0.2.6's defaults.  The state is
    ``{"count", "v_row", "v_col", "v"}`` with trees shaped like the
    parameters, in the parameters' dtype; gradients are taken in float32."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: Params) -> Dict[str, Any]:
        def parts(p):
            f = _factored_dims(p.shape)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if f is None:
                return one, one.clone(), torch.zeros_like(p)
            d1, d0 = f
            shape = list(p.shape)
            vr = torch.zeros([s for i, s in enumerate(shape) if i != d0], dtype=p.dtype,
                             device=p.device)
            vc = torch.zeros([s for i, s in enumerate(shape) if i != d1], dtype=p.dtype,
                             device=p.device)
            return vr, vc, one.clone()

        made = tree_map(parts, params)
        pick = lambda i: tree_map(lambda p, m: m[i], params, made)  # noqa: E731
        return {"count": 0, "v_row": pick(0), "v_col": pick(1), "v": pick(2)}

    def _leaf(self, g, vr, vc, v, p, decay):
        """One leaf's update and new second moments."""
        dtype = p.dtype
        gsq = g * g + EPS
        f = _factored_dims(p.shape)
        if f is not None:
            d1, d0 = f
            vr = (decay * vr.float() + (1 - decay) * gsq.mean(dim=d0)).to(dtype)
            vc = (decay * vc.float() + (1 - decay) * gsq.mean(dim=d1)).to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (vr / vr.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            col_factor = vc ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = (decay * v.float() + (1 - decay) * gsq).to(dtype)
            u = g * v ** -0.5
        u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / CLIPPING_THRESHOLD, min=1.0)
        u = u * self.lr
        rms = torch.sqrt(torch.mean(p * p))
        u = u * torch.where(rms <= MIN_SCALE, torch.full_like(rms, MIN_SCALE), rms)
        return -u, vr, vc, v

    @torch.no_grad()
    def step_(self, grads: List[torch.Tensor], state: Dict[str, Any], params: Params,
              grad_scale: torch.Tensor | float = 1.0) -> None:
        """Update ``params`` and ``state`` in place, leaf by leaf, with the
        gradients ``grads[i].float() * grad_scale`` (``grads`` in
        ``tree_leaves(params)`` order, each released once used)."""
        t = np.float32(state["count"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-DECAY_RATE)
        leaves = zip(tree_leaves(params), tree_leaves(state["v_row"]),
                     tree_leaves(state["v_col"]), tree_leaves(state["v"]))
        for i, (p, vr, vc, v) in enumerate(leaves):
            g = grads[i].to(torch.float32) * grad_scale
            u, vr2, vc2, v2 = self._leaf(g, vr, vc, v, p, decay)
            grads[i] = None
            vr.copy_(vr2)
            vc.copy_(vc2)
            v.copy_(v2)
            p.copy_(apply_update(p, u))
        state["count"] += 1


def apply_update(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``optax.apply_updates`` for one leaf: ``p + u`` in the promoted dtype,
    rounded to ``p``'s."""
    return (p.to(torch.promote_types(p.dtype, u.dtype)) + u).to(p.dtype)


def make_optimizer(cfg: Dynam3DConfig) -> Adafactor:
    return Adafactor(cfg.train.lr)


class TrainBatch(NamedTuple):
    rgb: torch.Tensor          # [B, V, H, W, 3] uint8
    depth: torch.Tensor        # [B, V, Hd, Wd] float32
    position: torch.Tensor     # [B, 3]
    heading: torch.Tensor      # [B]
    input_ids: torch.Tensor    # [B, T]
    text_valid: torch.Tensor   # [B, T]
    label_ids: torch.Tensor    # [B, Tg]
    label_mask: torch.Tensor   # [B, Tg]
    turn_weight: torch.Tensor  # [B]


@torch.no_grad()
def scrub_and_clip(grads: List[torch.Tensor], max_norm: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero NaN gradients in place; returns the clip scale ``min(1,
    max_norm / (norm + 1e-12))`` and the global norm.  A leaf's clipped
    gradient is ``g.float() * scale``."""
    for g in grads:
        g.masked_fill_(torch.isnan(g), 0.0)
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
    return torch.clamp(max_norm / (gnorm + 1e-12), max=1.0), gnorm


def make_train_step(cfg: Dynam3DConfig, optimizer: Adafactor, splice_start: int = 2):
    """The IL step ``(trainable, frozen, opt_state, field_state, batch) ->
    (trainable, opt_state, field_state, metrics)``.  ``trainable`` and
    ``opt_state`` are updated in place; the memory update of ``perceive``
    is not recorded by autograd (only ``trainable`` takes gradients, and
    only inside the step)."""

    def step(trainable: Params, frozen: Params, opt_state, field_state: FieldState,
             batch: TrainBatch):
        leaves = tree_leaves(trainable)
        for t in leaves:
            t.requires_grad_(True)
        try:
            p = merge_params(trainable, frozen)
            out = policy_mod.perceive(p, cfg, field_state, batch.rgb, batch.depth,
                                      batch.position, batch.heading)
            tl = policy_mod.train_loss(p, cfg, batch.input_ids, batch.text_valid,
                                       out.mm_tokens, out.mm_valid, batch.label_ids,
                                       batch.label_mask, batch.turn_weight, splice_start)
            grads = torch.autograd.grad(tl.loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        scale, gnorm = scrub_and_clip(grads, cfg.train.grad_clip_norm)
        loss = tl.loss.detach()
        skip = bool(torch.isnan(loss))
        if not skip:
            optimizer.step_(grads, opt_state, trainable, scale)
        del grads
        new_state = FieldState(*(t.detach() for t in out.state))
        return trainable, opt_state, new_state, {"loss": loss, "grad_norm": gnorm,
                                                 "skipped": skip}

    return step
