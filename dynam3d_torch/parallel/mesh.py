"""Process meshes and sharding rules; port of ``parallel/mesh.py``.

The reference trains data-parallel on 4-process DDP over NCCL
(ss_trainer_Dynam3D.py:186-190; SURVEY.md §2.3).  The port does the same on
``torch.distributed``: a ``dp x tp`` mesh of processes, one card a rank.
On top of the reference, which has no tensor parallelism, LLaVA-Phi-3 may
shard over the ``tp`` axis: attention heads and MLP columns split, their
output projections row-split, so each layer makes exactly two all-reduces
(Megatron's layout; ``models/vlm/phi3.py`` writes them out,
``parallel/comm.py`` counts them).

A spec is a leaf's shard dimension (``0`` rows, ``1`` columns) or ``None``
(replicated), the counterpart of a ``PartitionSpec`` over ``"tp"``.
:func:`shard_tree` keeps this rank's slice of each leaf, :func:`unshard_tree`
gathers the slices back (a checkpoint holds whole leaves, so a TP run's
checkpoint loads into one process and the other way round).

No pipeline, sequence or expert parallelism: the reference has none to
match (SURVEY.md §2.3), prompts are 1-5k tokens and there is no MoE.  No TP
of int4 weights either: :func:`split_qkv_params` refuses quantized trees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch.distributed as dist

from dynam3d_torch.parallel.comm import all_gather_cat
from dynam3d_torch.utils.tree import tree_leaves, tree_map


@dataclass
class Mesh:
    """This rank's place in a ``dp x tp`` mesh: global rank
    ``dp_rank * tp + tp_rank`` (the JAX mesh's ``reshape(dp, tp)``).  A
    group of one rank is ``None`` (nothing to communicate)."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[Any]
    tp_group: Optional[Any]


def make_mesh(dp: int, tp: int = 1) -> Mesh:
    """The dp and tp process groups over the initialized default group of
    ``dp * tp`` ranks.  Every rank calls it (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * tp:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, have {world}")
    dp_group = tp_group = None
    for i in range(dp):                      # tp groups: one mesh row each
        ranks = [i * tp + j for j in range(tp)]
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            tp_group = g
    for j in range(tp):                      # dp groups: one mesh column each
        ranks = [i * tp + j for i in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            dp_group = g
    return Mesh(dp, tp, rank // tp, rank % tp, dp_group, tp_group)


def split_qkv_params(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Fused Phi-3 params -> the TP layout (``wq/wk/wv``, ``wgate/wup``).

    A column split of the fused ``[D, q|k|v]`` / ``[D, gate|up]`` matrices
    would cross the concat boundaries; separate head-aligned matrices give
    each rank whole heads and a matching gate/up pair.  ``phi3.forward``
    accepts both layouts.  The new leaves are copies."""
    q_sz = cfg.num_heads * cfg.head_dim
    kv_sz = cfg.num_kv_heads * cfg.head_dim

    def layer(lp):
        w, gu = lp["qkv"], lp["gate_up"]
        if isinstance(w, dict) or isinstance(gu, dict):
            raise ValueError("split_qkv_params expects unquantized weights")
        out = {k: v for k, v in lp.items() if k not in ("qkv", "gate_up")}
        out["wq"] = w[:, :q_sz].contiguous()
        out["wk"] = w[:, q_sz: q_sz + kv_sz].contiguous()
        out["wv"] = w[:, q_sz + kv_sz:].contiguous()
        i_sz = gu.shape[1] // 2
        out["wgate"] = gu[:, :i_sz].contiguous()
        out["wup"] = gu[:, i_sz:].contiguous()
        return out

    return {**params, "layers": [layer(lp) for lp in params["layers"]]}


def phi3_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Megatron specs of the Phi-3 tree: ``wq/wk/wv`` (or a fused ``qkv``)
    and ``wgate/wup`` (or ``gate_up``) column-split, ``o`` and ``down``
    row-split, the embedding rows (vocab) and the ``lm_head`` columns
    (vocab) split, norms replicated."""

    def layer(lp):
        specs = {"input_ln": None, "o": 0, "post_ln": None, "down": 0}
        for k in ("wq", "wk", "wv", "qkv", "wgate", "wup", "gate_up"):
            if k in lp:
                specs[k] = 1
        return specs

    return {
        "embed_tokens": 0,
        "layers": [layer(lp) for lp in params["layers"]],
        "final_ln": None,
        "lm_head": 1,
    }


def replicated_specs(tree: Any) -> Any:
    return tree_map(lambda _: None, tree)


def policy_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of the whole VLN policy tree: Phi-3 TP-split, everything else
    (CLIP towers, 3D-memory modules, projectors: < 1 GB) replicated."""
    specs = {k: replicated_specs(v) for k, v in params.items()}
    specs["llava"] = {
        "clip": replicated_specs(params["llava"]["clip"]),
        "projector": replicated_specs(params["llava"]["projector"]),
        "phi3": phi3_param_specs(params["llava"]["phi3"]),
    }
    return specs


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's slice of each leaf (a copy; replicated leaves as they
    are).  A split dimension must divide by ``mesh.tp``."""

    def shard(x, s):
        if s is None or mesh.tp == 1:
            return x
        if x.shape[s] % mesh.tp:
            raise ValueError(f"dim {s} of {tuple(x.shape)} does not split {mesh.tp} ways")
        return x.chunk(mesh.tp, dim=s)[mesh.tp_rank].contiguous()

    return tree_map(shard, tree, specs)


def unshard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The inverse of :func:`shard_tree`: every leaf whole on every rank of
    the tp group (one all-gather a split leaf)."""

    def gather(x, s):
        if s is None or mesh.tp == 1:
            return x
        return all_gather_cat(x, s, mesh.tp_group, "unshard")

    return tree_map(gather, tree, specs)


def data_sharding(mesh: Mesh, batch: int) -> slice:
    """The rows of a global batch of ``batch`` rows this dp rank takes
    (contiguous, equal shares)."""
    if batch % mesh.dp:
        raise ValueError(f"a batch of {batch} rows does not split over dp={mesh.dp}")
    n = batch // mesh.dp
    return slice(mesh.dp_rank * n, (mesh.dp_rank + 1) * n)


def leaf_specs_like(tree: Any, specs: Optional[Any]) -> list:
    """``specs`` as a list in ``tree_leaves(tree)`` order (all ``None``
    without specs)."""
    if specs is None:
        return [None] * len(tree_leaves(tree))
    return tree_leaves(tree_map(lambda _, s: s, tree, specs))
