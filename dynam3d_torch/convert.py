"""Parameters of the reference package -> parameters of the port.

``params_from_jax(tree)`` takes the reference's parameter tree with numpy
leaves (``jax.tree_util.tree_map(np.asarray, params)`` on the caller's
side) — nested dicts and lists of arrays, packed int4 weights as objects
with ``q4``/``s_lo``/``s_hi``/``d``/``n``/``dblk``/``nblk`` attributes, flat
or block-major —
and returns the same tree of torch tensors on ``device``, so that both
packages compute the same function on the same weights.  The waypoint
predictor's tree converts through the same walk; the trees of
convolutional networks (the YOLOv8-seg segmenter, the depth encoder)
through ``conv_params_from_jax``, which lays their weights out OIHW.  ``state_from_jax``
does the same for a memory state, so both packages can start from one
memory.  Nothing of JAX is imported: the trees are read by duck typing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynam3d_torch.device import DeviceLike, resolve_device
from dynam3d_torch.ops.int4 import Int4Weight


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _int4(w, device: torch.device) -> Int4Weight:
    """A packed int4 weight in the port's flat layout: a block-major pack
    (``blocked``, ``q4 [nb, Dp, nblk]``) is laid out flat, byte for byte."""
    q4 = np.asarray(w.q4)
    if getattr(w, "blocked", False):
        nb, dp, nblk = q4.shape
        q4 = q4.transpose(1, 0, 2).reshape(dp, nb * nblk)
    return Int4Weight(_tensor(q4, device), _tensor(w.s_lo, device),
                      _tensor(w.s_hi, device), int(w.d), int(w.n), int(w.dblk),
                      int(w.nblk))


def conv_params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A reference tree of a convolutional network (numpy leaves, HWIO
    convolution weights, in dicts and lists: YOLOv8-seg, the depth
    encoder) -> the port's, with the weights laid out OIHW once."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        t = _tensor(node, device)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    return conv(tree)


_CONV_SUBTREES = ("yolo", "depth_enc")


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Convert a reference parameter tree (numpy leaves) to torch; a
    ``yolo`` or ``depth_enc`` subtree goes through
    :func:`conv_params_from_jax`."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv_params_from_jax(v, device) if k in _CONV_SUBTREES else conv(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        if all(hasattr(node, a) for a in ("q4", "s_lo", "s_hi", "dblk", "nblk")):
            return _int4(node, device)
        return _tensor(node, device)

    return conv(tree)


def state_from_jax(state: Any, device: DeviceLike = None):
    """A reference ``FieldState`` (numpy leaves or arrays) -> the port's,
    with integer tables widened to int64 (the port's index type)."""
    from dynam3d_torch.models.memory3d.state import FieldState

    device = resolve_device(device)

    def conv(a):
        t = _tensor(a, device)
        return t.to(torch.int64) if t.dtype == torch.int32 else t

    return FieldState(*(conv(a) for a in state))
