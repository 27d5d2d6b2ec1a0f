"""The fused NeRF MLP of the renderer (kernel C).

Port of ``ops/pallas_mlp.py::fused_nerf_mlp``: encoder 2 x (D -> D,
LeakyReLU 0.01, -> bf16) -> D -> D+1 LeakyReLU (the last column is the
density) -> residual ``bf16(enc + x)`` -> decoder 2 x (D -> D LeakyReLU
-> bf16) -> D -> D linear -> bf16; weights rounded to bf16, products summed
in float32.  On a CUDA tensor :func:`fused_nerf_mlp` launches
``csrc/nerf_mlp.cu``; on a CPU tensor it runs :func:`nerf_mlp_plain`, the
same arithmetic in PyTorch.  Forward only: the renderer's gradient is the
autograd of its own chain (``models/render/nerf.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dynam3d_torch.ops import kernels
from dynam3d_torch.ops.transformer import dot_f32

Weights = Tuple[torch.Tensor, ...]     # e1, e2, eo [D, D+1], d1, d2, do


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01) in the dtype of ``x`` (the slope rounded to it)."""
    slope = torch.tensor(0.01, dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, x, slope * x)


def _check_args(x: torch.Tensor, w: Weights) -> None:
    kernels.require(x.dim() == 2, "nerf_mlp: x must be [N, D]")
    D = x.shape[1]
    kernels.require(len(w) == 6, "nerf_mlp: six weights (e1, e2, eo, d1, d2, do)")
    for i, t in enumerate(w):
        shape = (D, D + 1) if i == 2 else (D, D)
        kernels.require(tuple(t.shape) == shape, f"nerf_mlp: weight {i} must be {shape}")


def nerf_mlp_plain(x: torch.Tensor, *w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of kernel C: ``(out [N, D] bf16, density [N] bf16)``."""
    _check_args(x, w)
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "nerf_mlp")
    e1, e2, eo, d1, d2, do = (t.to(torch.bfloat16) for t in w)
    xb = x.to(torch.bfloat16)
    h = xb
    for wt in (e1, e2):
        h = leaky_relu(dot_f32(h, wt)).to(torch.bfloat16)
    o = leaky_relu(dot_f32(h, eo))
    enc, density = o[:, :-1], o[:, -1]
    h = (enc + xb.to(torch.float32)).to(torch.bfloat16)
    for wt in (d1, d2):
        h = leaky_relu(dot_f32(h, wt)).to(torch.bfloat16)
    return dot_f32(h, do).to(torch.bfloat16), density.to(torch.bfloat16)


def _bind(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nerf_mlp.argtypes = [P, I, I, P, P, P, P, P, P, P, P, P, P]
    lib.nerf_mlp.restype = I
    lib._d3_bound = True


def nerf_mlp_cuda(x: torch.Tensor, *w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel C (``csrc/nerf_mlp.cu``) on CUDA tensors.

    The weights are rounded to bf16 here (as the TPU kernel's wrapper does)
    and EO is split into its ``[D, D]`` body and its density column."""
    _check_args(x, w)
    N, D = x.shape
    kernels.require(D % 128 == 0 and 128 <= D <= 1024,
                    "nerf_mlp: the kernel takes D = 128..1024 in steps of 128")
    xb = x.to(torch.bfloat16).contiguous()
    e1, e2, eo, d1, d2, do = (t.to(torch.bfloat16) for t in w)
    eo_body, eo_col = eo[:, :D].contiguous(), eo[:, D].contiguous()
    ws = [t.contiguous() for t in (e1, e2, eo_body, d1, d2, do)]
    kernels.require_cuda([xb, eo_col, *ws], "nerf_mlp")
    for t in (xb, *ws):
        kernels.require(t.data_ptr() % 16 == 0, "nerf_mlp: tensors must be 16-byte aligned")
    lib = kernels.library("nerf_mlp")
    _bind(lib)
    out = torch.empty((N, D), dtype=torch.bfloat16, device=x.device)
    density = torch.empty((N,), dtype=torch.bfloat16, device=x.device)
    rc = lib.nerf_mlp(xb.data_ptr(), N, D, ws[0].data_ptr(), ws[1].data_ptr(),
                      ws[2].data_ptr(), eo_col.data_ptr(), ws[3].data_ptr(),
                      ws[4].data_ptr(), ws[5].data_ptr(), out.data_ptr(),
                      density.data_ptr(), kernels.stream_ptr(x))
    kernels.check(rc, "nerf_mlp")
    kernels.count(kernels.launches, "nerf_mlp")
    return out, density


def fused_nerf_mlp(x: torch.Tensor, *w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return nerf_mlp_cuda(x, *w)
    return nerf_mlp_plain(x, *w)
