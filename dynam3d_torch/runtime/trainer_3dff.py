"""3DFF pretraining steps of the posed-frames and walk drivers; port of
``runtime/trainer_3dff.py`` (``PretrainBatch``, ``pretrain_step_loss``,
``losses_after_update``, ``make_pretrain_optimizer``,
``make_pretrain_step``, ``WalkBatch``, ``walk_step_loss``,
``make_walk_grad_step``, ``apply_accumulated_grads``, ``draw_dataset_id``).

One step folds the V input views into a fresh memory (each view's update
recomputed in the backward pass, as the reference rematerializes it),
renders the novel views back and sums the loss family: update-time
alignment (instance and pseudo-zone: InfoNCE / 5, cosine, subspace cosine),
the balanced merge CE, the render losses (subspace cosine x 2, cosine x 5,
InfoNCE / 5), the per-ray category focal loss / 10 and the instance / zone
text alignment.  The optimizer is AdamW (lr ``pretrain_lr``, weight decay
1e-4) after a per-value gradient clip; NaN gradients read as zero, and a
NaN loss keeps the parameters while the optimizer state still advances.
A walk step returns its gradients instead; the walk driver sums them over
the episode and makes one update from their mean, with no NaN-loss skip.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dynam3d_torch.config import Dynam3DConfig
from dynam3d_torch.models.memory3d.pretrain import stack_aux, unstack_aux, update_view_pretrain
from dynam3d_torch.models.memory3d.state import FieldState, unstack_state
from dynam3d_torch.models.policy_3dff import perceive_panorama
from dynam3d_torch.models.render.nerf import render_view, render_view_posed
from dynam3d_torch.ops.knn import knn_brute
from dynam3d_torch.parallel.comm import dp_mean_
from dynam3d_torch.runtime import profiling
from dynam3d_torch.runtime.losses_3dff import (
    balanced_merge_ce, contrastive_loss, cosine_loss, focal_loss, l2n, subspace_cosine_loss,
)
from dynam3d_torch.utils.tree import tree_leaves, tree_unflatten

Params = Dict[str, Any]


class PretrainBatch(NamedTuple):
    """One pretraining step's inputs (one scene)."""

    depth: torch.Tensor           # [V, HW] metric patch-grid depth
    grid_fts: torch.Tensor        # [V, HW, D] CLIP patch features
    cls_fts: torch.Tensor         # [V, D] CLIP CLS features (zone target)
    segm: torch.Tensor            # [V, HW]
    position: torch.Tensor        # [V, 3] world frame
    heading: torch.Tensor         # [V]
    gt_xyz: torch.Tensor          # [G, 3] gt point cloud
    gt_label: torch.Tensor        # [G]
    gt_valid: torch.Tensor        # [G]
    novel_position: torch.Tensor  # [Nv, 3]
    novel_heading: torch.Tensor   # [Nv]
    novel_gt_fts: torch.Tensor    # [Nv, R, D] pooled CLIP targets
    cat_embeddings: torch.Tensor  # [C, D] category text embeddings
    gtid_to_cat: torch.Tensor     # [L] gt instance id -> category (-1 none)
    gtid_text_fts: torch.Tensor   # [L, D] gt instance id -> caption feature
    gtid_text_valid: torch.Tensor  # [L]
    use_labels: torch.Tensor      # scalar bool
    ppos: torch.Tensor            # [V, HW, 3] world patch positions
    pdir: torch.Tensor            # [V, HW] patch directions
    pscale: torch.Tensor          # [V, HW] patch scales
    novel_k: Any = None           # [3, 3] view-resolution K (posed)
    novel_rot: Any = None         # [Nv, 3, 3] camera-to-world R (posed)
    novel_trans: Any = None       # [Nv, 3] camera-to-world T (posed)


# --- loss ------------------------------------------------------------------

def pretrain_step_loss(params: Params, cfg: Dynam3DConfig, state: FieldState,
                       batch: PretrainBatch, max_gt_label: int = 512, posed: bool = False,
                       ) -> Tuple[torch.Tensor, FieldState, Dict[str, torch.Tensor]]:
    """Fold the views in order, then the loss family; returns ``(loss,
    new_state, metrics)``.  The spans ``pretrain.fold`` (the forward loop
    over the views: the backward's recompute of each view runs outside it)
    and ``pretrain.losses``."""
    f = cfg.fields

    def step(st, d, g, sg, pos, hd, pp, pd, ps):
        return update_view_pretrain(params["fields"], st, f, d, g, sg, pos, hd, batch.gt_xyz,
                                    batch.gt_label, batch.gt_valid, max_gt_label,
                                    geometry=(pp, pd, ps))

    auxes = []
    with profiling.span("pretrain.fold"):
        for v in range(batch.depth.shape[0]):
            xs = (batch.depth[v], batch.grid_fts[v], batch.segm[v], batch.position[v],
                  batch.heading[v], batch.ppos[v], batch.pdir[v], batch.pscale[v])
            if torch.is_grad_enabled():
                # keep only the view's inputs; the backward pass recomputes the
                # update (its re-aggregation activations would not fit for 16 views)
                state, aux = checkpoint(step, state, *xs, use_reentrant=False)
            else:
                state, aux = step(state, *xs)
            auxes.append(aux)
    with profiling.span("pretrain.losses"):
        loss, metrics = losses_after_update(params, cfg, state, stack_aux(auxes), batch,
                                            posed=posed)
    return loss, state, metrics


def losses_after_update(params: Params, cfg: Dynam3DConfig, state: FieldState, aux, batch,
                        posed: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 3DFF loss family from a folded state and the stacked per-view
    aux (``[V]`` leading axis)."""
    f = cfg.fields
    D, S = f.fts_dim, f.max_segments
    V = aux.base.seg_active.shape[0]
    dev = batch.cls_fts.device

    act = aux.base.seg_active.reshape(-1)
    seg_fts = aux.base.seg_fts.reshape(-1, D)
    tgt_fts = aux.target_seg_fts.reshape(-1, D)
    pmean = torch.repeat_interleave(aux.patch_mean_fts, S, dim=0)

    # update-time alignment
    sim_loss = contrastive_loss(seg_fts, tgt_fts, act) / 5.0
    sim_loss = sim_loss + cosine_loss(seg_fts, tgt_fts, act)
    sim_loss = sim_loss + subspace_cosine_loss(seg_fts, tgt_fts, pmean, pmean, act)
    vmask = torch.ones(V, dtype=torch.bool, device=dev)
    sim_loss = sim_loss + contrastive_loss(aux.zone_pred_fts, batch.cls_fts, vmask) / 5.0
    sim_loss = sim_loss + cosine_loss(aux.zone_pred_fts, batch.cls_fts, vmask)
    cls_mean = batch.cls_fts.mean(dim=0)
    sim_loss = sim_loss + subspace_cosine_loss(aux.zone_pred_fts, batch.cls_fts, cls_mean,
                                               cls_mean, vmask)

    # merge-discriminator CE
    segm_loss = balanced_merge_ce(aux.base.merge_logits.reshape(-1),
                                  aux.merge_target.reshape(-1),
                                  aux.merge_valid.reshape(-1) & batch.use_labels)

    # novel-view rendering, a span ``pretrain.render`` each
    outs = []
    if posed:
        for rot, trans in zip(batch.novel_rot, batch.novel_trans):
            with profiling.span("pretrain.render"):
                outs.append(render_view_posed(params["render"], f, state, batch.novel_k, rot,
                                              trans))
    else:
        for pos, hd in zip(batch.novel_position, batch.novel_heading):
            with profiling.span("pretrain.render"):
                outs.append(render_view(params["render"], f, state, pos, hd))
    nv_fts = torch.stack([o.features.reshape(-1, D) for o in outs])       # [Nv, R, D]
    nv_pos = torch.stack([o.positions.reshape(-1, 3) for o in outs])
    pred = nv_fts.reshape(-1, D).to(torch.float32)
    gt = batch.novel_gt_fts.reshape(-1, D).to(torch.float32)
    ray_mask = torch.ones(pred.shape[0], dtype=torch.bool, device=dev)
    nv_gt_mean = batch.novel_gt_fts.mean(dim=1, keepdim=True)
    nv_pr_mean = nv_fts.mean(dim=1, keepdim=True)
    render_loss = 2.0 * cosine_loss((nv_fts - nv_pr_mean).reshape(-1, D),
                                    (batch.novel_gt_fts - nv_gt_mean).reshape(-1, D), ray_mask)
    render_loss = render_loss + 5.0 * cosine_loss(pred, gt, ray_mask)
    render_loss = render_loss + contrastive_loss(pred, gt, ray_mask) / 5.0

    # per-ray category focal loss
    sqd, nn = knn_brute(nv_pos.reshape(-1, 3), batch.gt_xyz, batch.gt_valid, 1)
    ray_gt = batch.gt_label[nn[:, 0]].to(torch.int64)
    L = batch.gtid_to_cat.shape[0]
    ray_cat = batch.gtid_to_cat[torch.clamp(ray_gt, 0, L - 1)].to(torch.int64)
    ray_ok = (torch.sqrt(sqd[:, 0]) < f.search_radius) & (ray_gt > 0) & batch.use_labels \
        & (ray_cat >= 0)
    cat_logits = 10.0 * (l2n(pred) @ batch.cat_embeddings.T)
    lang_loss = focal_loss(cat_logits, ray_cat, ray_ok) / 10.0

    # instance / zone text alignment
    ipred = aux.inst_pred_fts.reshape(-1, D)
    igt = aux.inst_pred_gt.reshape(-1)
    iok = (igt >= 0) & act & batch.use_labels
    icat = batch.gtid_to_cat[torch.clamp(igt, 0, L - 1)].to(torch.int64)
    cat_ok = iok & (icat >= 0)
    lp = F.log_softmax(10.0 * (l2n(ipred) @ batch.cat_embeddings.T), dim=-1)
    ice = -torch.gather(lp, -1, torch.clamp(icat, min=0)[:, None])[:, 0]
    text_loss = (ice * cat_ok).sum() / torch.clamp(cat_ok.to(torch.float32).sum(), min=1.0) / 10.0
    Lt = batch.gtid_text_fts.shape[0]
    itext = batch.gtid_text_fts[torch.clamp(igt, 0, Lt - 1)]
    it_ok = iok & batch.gtid_text_valid[torch.clamp(igt, 0, batch.gtid_text_valid.shape[0] - 1)]
    text_loss = text_loss + contrastive_loss(ipred, itext, it_ok) / 5.0

    zgt = aux.zone_member_gt[..., 0].reshape(-1)
    zpred = aux.zone_pred_zone_fts.reshape(-1, D)
    zok = (aux.zone_touch_valid.reshape(-1) & (zgt >= 0) & batch.use_labels
           & batch.gtid_text_valid[torch.clamp(zgt, 0, batch.gtid_text_valid.shape[0] - 1)])
    ztext = batch.gtid_text_fts[torch.clamp(zgt, 0, Lt - 1)]
    text_loss = text_loss + contrastive_loss(zpred, ztext, zok) / 5.0

    loss = sim_loss + segm_loss + render_loss + lang_loss + text_loss
    metrics = {"sim_loss": sim_loss, "segm_loss": segm_loss, "render_loss": render_loss,
               "lang_loss": lang_loss, "text_loss": text_loss}
    return loss, metrics


# --- optimizer -------------------------------------------------------------

class PretrainOptimizer:
    """Per-value gradient clip, then AdamW with decoupled weight decay,
    step for step the reference's ``chain(clip(c), adamw(lr))``: ``mu``,
    ``nu`` and the count live in an explicit state, so a skipped step can
    keep the parameters and still advance the state."""

    def __init__(self, lr: float, clip: float, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip, self.wd = lr, clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any], params):
        """Updates (to add to the parameters, in leaf order) and the new state."""
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        updates, mus, nus = [], [], []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], tree_leaves(params)):
            g = torch.clamp(g, -self.clip, self.clip)
            mu = (1.0 - self.b1) * g + self.b1 * mu
            nu = (1.0 - self.b2) * (g * g) + self.b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            updates.append(-self.lr * (u + self.wd * p))
            mus.append(mu)
            nus.append(nu)
        return updates, {"count": count, "mu": mus, "nu": nus}


def make_pretrain_optimizer(cfg: Dynam3DConfig) -> PretrainOptimizer:
    """AdamW (lr ``pretrain_lr``, weight decay 1e-4) after a per-value clip
    at ``grad_clip_value``."""
    return PretrainOptimizer(cfg.train.pretrain_lr, cfg.train.grad_clip_value)


def make_pretrain_step(cfg: Dynam3DConfig, optimizer: PretrainOptimizer, posed: bool = False,
                       dp=None):
    """``step(trainable, opt_state, field_state, batch) -> (new_trainable,
    new_opt_state, new_field_state, metrics)`` over the trainable subtree
    (``fields`` and ``render``; the encoders stay frozen).

    ``dp``: a data-parallel group, one scene a rank.  The step then takes
    the gradient of the ranks' mean loss (``__graft_entry__``'s
    ``_dryrun_pretrain_dp``, the reference's DDP): the gradients are
    averaged over the group in float32 buckets before the NaN scrub, and
    ``metrics["loss"]`` is the mean, so a NaN on any rank skips the update
    on every rank.  The other metrics stay this rank's.

    Spans: ``pretrain.backward`` (the gradient, and with it the views'
    recomputed folds) and ``pretrain.update`` (the NaN scrub, AdamW and the
    skip read)."""

    def step(trainable, opt_state, field_state, batch: PretrainBatch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainable)]
        tr = tree_unflatten(trainable, leaves)
        loss, new_state, metrics = pretrain_step_loss(tr, cfg, field_state, batch, posed=posed)
        with profiling.span("pretrain.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with profiling.span("pretrain.update"):
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
            loss = loss.detach()
            if dp is not None:
                loss = dp_mean_(grads, loss, 1.0, dp)
            grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g) for g in grads]
            updates, new_opt = optimizer.update(grads, opt_state, trainable)
            profiling.count("sync")
            skip = bool(torch.isnan(loss))
            if skip:
                new_tr = trainable
            else:
                new_tr = tree_unflatten(trainable, [p.detach() + u for p, u in
                                                    zip(tree_leaves(trainable), updates)])
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss
            metrics["skipped"] = torch.tensor(skip)
        new_state = FieldState(*(t.detach() for t in new_state))
        return new_tr, new_opt, new_state, metrics

    return step


# --- walk step ---------------------------------------------------------------

class WalkBatch(NamedTuple):
    """One walk step's inputs (one episode)."""

    rgb12: torch.Tensor           # [12, Hc, Wc, 3] uint8 panorama, counter-clockwise
    depth12: torch.Tensor         # [12, Hd, Wd] normalized depth
    position: torch.Tensor        # [3] habitat-frame agent position
    heading: torch.Tensor         # [] agent heading
    gt_xyz: torch.Tensor          # [G, 3] scene gt point cloud (world)
    gt_label: torch.Tensor        # [G]
    gt_valid: torch.Tensor        # [G]
    novel_position: torch.Tensor  # [Nv, 3] world-frame novel cameras
    novel_heading: torch.Tensor   # [Nv]
    novel_gt_fts: torch.Tensor    # [Nv, R, D] pooled CLIP targets of the views
    cat_embeddings: torch.Tensor  # [C, D]
    gtid_to_cat: torch.Tensor     # [L]
    gtid_text_fts: torch.Tensor   # [L, D]
    gtid_text_valid: torch.Tensor  # [L]
    use_labels: torch.Tensor      # scalar bool


class _LossInputs(NamedTuple):
    """The fields of a PretrainBatch that ``losses_after_update`` reads."""

    cls_fts: Any
    novel_position: Any
    novel_heading: Any
    novel_gt_fts: Any
    gt_xyz: Any
    gt_label: Any
    gt_valid: Any
    cat_embeddings: Any
    gtid_to_cat: Any
    gtid_text_fts: Any
    gtid_text_valid: Any
    use_labels: Any
    novel_k: Any = None
    novel_rot: Any = None
    novel_trans: Any = None


def walk_step_loss(params: Params, cfg: Dynam3DConfig, state: FieldState, batch: WalkBatch,
                   ) -> Tuple[torch.Tensor, FieldState, Dict[str, torch.Tensor]]:
    """One walk step: the memory (batched ``[1, ...]``, detached here) folds
    the panorama's four views in, then the loss family renders the novel
    views.  Contrastive terms normalize over this step's rays and
    instances, as the reference's per-step program does."""
    state = FieldState(*(t.detach() for t in state))
    pp = perceive_panorama(params, cfg, state, batch.rgb12[None], batch.depth12[None],
                           batch.position[None], batch.heading[None],
                           gt_xyz=batch.gt_xyz[None], gt_label=batch.gt_label[None],
                           gt_valid=batch.gt_valid[None], with_waypoints=False)
    state1 = unstack_state(pp.state, 0)
    inputs = _LossInputs(
        cls_fts=pp.cls_fts[0], novel_position=batch.novel_position,
        novel_heading=batch.novel_heading, novel_gt_fts=batch.novel_gt_fts,
        gt_xyz=batch.gt_xyz, gt_label=batch.gt_label, gt_valid=batch.gt_valid,
        cat_embeddings=batch.cat_embeddings, gtid_to_cat=batch.gtid_to_cat,
        gtid_text_fts=batch.gtid_text_fts, gtid_text_valid=batch.gtid_text_valid,
        use_labels=batch.use_labels)
    loss, metrics = losses_after_update(params, cfg, state1, unstack_aux(pp.aux, 0), inputs)
    return loss, pp.state, metrics


def make_walk_grad_step(cfg: Dynam3DConfig):
    """``step(trainable, frozen, state, batch) -> (grads, new_state,
    metrics)``: the gradients of one walk step's loss over the trainable
    tree (a tree of the same shape; zero where a leaf is unused), the state
    detached.  The driver sums them over the episode and applies one update
    (:func:`apply_accumulated_grads`)."""

    def step(trainable, frozen, state, batch: WalkBatch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(trainable)]
        loss, new_state, metrics = walk_step_loss(
            {**frozen, **tree_unflatten(trainable, leaves)}, cfg, state, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return (tree_unflatten(trainable, grads), FieldState(*(t.detach() for t in new_state)),
                metrics)

    return step


@torch.no_grad()
def apply_accumulated_grads(optimizer: PretrainOptimizer, trainable, opt_state, grad_sum,
                            n_steps: int, dp=None):
    """The episode's update: the summed gradients over ``n_steps``, averaged
    over the ``dp`` group when there is one (each rank's episode mean
    weighs the same), NaN elements read as zero (a NaN at any step zeroes
    that element for the episode, on every rank), then one optimizer step.
    Returns ``(new_trainable, new_opt_state)``."""
    grads = [g / max(n_steps, 1) for g in tree_leaves(grad_sum)]
    if dp is not None:
        dp_mean_(grads, grads[0].new_zeros(()), 1.0, dp)
    grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g) for g in grads]
    updates, new_opt = optimizer.update(grads, opt_state, trainable)
    new_tr = tree_unflatten(trainable, [p.detach() + u for p, u in
                                        zip(tree_leaves(trainable), updates)])
    return new_tr, new_opt


# --- dataset draw ------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """The Threefry-2x32 block cipher (20 rounds) on one counter pair."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def draw_dataset_id(seed: int, iteration: int, n_datasets: int = 5) -> int:
    """Host-agreed dataset choice: the draw of the reference's
    ``randint(fold_in(PRNGKey(seed), iteration), (), 0, n)`` (Threefry keys,
    two 32-bit words folded modulo ``n``), computed on the host."""
    key = _threefry2x32(0, seed & _M32, 0, iteration & _M32)        # fold_in
    bits = []
    for i in (0, 1):                                                # split, then 32 bits each
        sub = _threefry2x32(*key, 0, i)
        b0, b1 = _threefry2x32(*sub, 0, 0)
        bits.append(b0 ^ b1)
    span = max(int(n_datasets), 1)
    mult = ((2 ** 16 % span) ** 2) % span
    return int(((bits[0] % span) * mult + bits[1] % span) % span)
