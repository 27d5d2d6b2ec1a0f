"""The collectives of the port's parallel layer, each counted.

XLA inserts the collectives of a sharded program from its sharding specs;
the port writes them out.  Every collective goes through one wrapper here,
which adds one to ``counts[tag]``:

* ``reduce_from_tp`` (Megatron's *g*): all-reduce forward, identity
  backward.  It ends a row-parallel product (``o``, ``down``: tag
  ``"layer"``) and sums the vocab-split embedding (``"embed"``).
* ``copy_to_tp`` (Megatron's *f*): identity forward, all-reduce of the
  gradient backward (``"backward"``), at the input of a column-parallel
  product.  ``torch.distributed.nn.functional.all_reduce`` would all-reduce
  the gradient after a row-parallel layer too, where every rank's upstream
  gradient is already the whole one, and multiply it by the group's size.
* ``gather_from_tp``: the vocab-split logits gathered along the last dim
  (``"logits"``); backward takes this rank's slice.
* ``all_reduce_`` for anything else: :func:`dp_mean_`'s gradient buckets
  (``"grad"``) and weighted loss (``"stats"``), TP norms (``"norm"``),
  optimizer statistics (``"adafactor"``).

``group=None`` everywhere means no parallelism: the functions return their
input and count nothing.  Gloo reduces CUDA tensors but has no all-gather
for them; there the gather is an all-reduce of a zero-padded buffer
(adding zeros is exact).
"""

from __future__ import annotations

import threading
from typing import Dict, List

import torch
import torch.distributed as dist

counts: Dict[str, int] = {}
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        counts.clear()


def _count(tag: str) -> None:
    with _lock:
        counts[tag] = counts.get(tag, 0) + 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """In-place sum of ``x`` over ``group`` (returns ``x``)."""
    if group is None:
        return x
    _count(tag)
    dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, dim: int, group, tag: str) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (all of the
    same shape)."""
    if group is None:
        return x
    n, r = group_size(group), group_rank(group)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(x.shape)
        w = shape[dim]
        shape[dim] = w * n
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, r * w, w).copy_(x)
        return all_reduce_(full, group, tag)
    _count(tag)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        return all_reduce_(x.clone(), group, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group, "backward"), None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, -1, group, tag)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(-1, r * ctx.width, ctx.width).contiguous(), None, None


def reduce_from_tp(x: torch.Tensor, group, tag: str = "layer") -> torch.Tensor:
    """g: the sum of the ranks' partial ``x`` (backward: identity)."""
    return x if group is None else _ReduceFromTP.apply(x, group, tag)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` as it is (backward: the ranks' gradients summed)."""
    return x if group is None else _CopyToTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, tag: str = "logits") -> torch.Tensor:
    """The ranks' last-dim slices concatenated (backward: this rank's slice)."""
    return x if group is None else _GatherFromTP.apply(x, group, tag)


GRAD_BUCKET = 1 << 27  # float32 elements in one all-reduce of gradients (512 MiB)


@torch.no_grad()
def dp_mean_(grads: List[torch.Tensor], loss: torch.Tensor, weight: float, dp) -> torch.Tensor:
    """Average ``grads`` in place over the ``dp`` group, each rank's weighted
    by ``weight`` (1, or 0 for a rank with no step to contribute: its
    gradients must be zeros); returns the weighted mean of ``loss``.  The
    leaves go in order into float32 buckets of at most ``GRAD_BUCKET``
    elements (a larger leaf alone), one all-reduce each."""
    dev = loss.device
    stats = torch.stack([loss.float() * weight, torch.tensor(float(weight), device=dev)])
    all_reduce_(stats, dp, "stats")
    total = stats[1]
    i = 0
    while i < len(grads):
        j, n = i + 1, grads[i].numel()
        while j < len(grads) and n + grads[j].numel() <= GRAD_BUCKET:
            n += grads[j].numel()
            j += 1
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        off = 0
        for g in grads[i:j]:
            buf[off: off + g.numel()].copy_(g.reshape(-1))
            off += g.numel()
        all_reduce_(buf, dp, "grad").div_(total)
        off = 0
        for g in grads[i:j]:
            g.copy_(buf[off: off + g.numel()].view_as(g))
            off += g.numel()
        i = j
    return stats[0] / total
