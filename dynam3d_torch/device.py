"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without a
card and without an explicit request they raise: nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

# data-sheet device-memory rates, bytes/s, by a part of the card's name
MEM_RATES = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H100", 3.35e12))


def mem_rate(name: str) -> float:
    """The data-sheet memory rate of the card called ``name`` (as
    ``torch.cuda.get_device_name`` or ``nvidia-smi`` print it)."""
    for key, rate in MEM_RATES:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def pin_full_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The depth unprojection, the k-NN distance expansion and the memory
    aggregation rely on fp32 cancellation (the TPU reference needed
    ``Precision.HIGHEST`` for the same reason); TF32 keeps ~3 decimal digits
    and would move patches by metres near zero distance.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; raises if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dynam3d_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain versions on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        pin_full_fp32()
    return dev
