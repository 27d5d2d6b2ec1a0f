"""Training checkpoints; port of the save / resume half of
``runtime/checkpoint.py``: ``ckpt.iter{N}`` files written with
``torch.save`` from host copies of the tensors, the newest found by mtime,
the step read from the name."""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from dynam3d_torch.utils.tree import tree_map


def save_checkpoint(ckpt_dir: str, step: int, payload: Any) -> str:
    """Write ``payload`` (nested dicts / lists of tensors and numbers) to
    ``ckpt_dir/ckpt.iter{step}``; tensors are copied to the host first."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"ckpt.iter{step}"))
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                        payload), path)
    return path


def load_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read a checkpoint; with ``template`` each tensor goes to the device
    and dtype of the template's tensor at the same place."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is None:
        return loaded
    return tree_map(lambda t, x: x.to(t.device, t.dtype) if isinstance(t, torch.Tensor) else x,
                    template, loaded)


def newest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``ckpt.iter*`` in ``ckpt_dir`` by mtime, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir) if d.startswith("ckpt.iter")]
    return max(cands, key=os.path.getmtime) if cands else None


def checkpoint_step(path: str) -> int:
    """The step in a checkpoint's name, -1 if it has none."""
    m = re.search(r"iter(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1
