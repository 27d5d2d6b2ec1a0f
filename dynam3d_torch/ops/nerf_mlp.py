"""The fused NeRF MLP of the renderer (kernel C).

Port of ``ops/pallas_mlp.py::fused_nerf_mlp``: encoder 2 x (D -> D,
LeakyReLU 0.01, -> bf16) -> D -> D+1 LeakyReLU (the last column is the
density) -> residual ``bf16(enc + x)`` -> decoder 2 x (D -> D LeakyReLU
-> bf16) -> D -> D linear -> bf16; weights rounded to bf16, products summed
in float32.  On a CUDA tensor :func:`fused_nerf_mlp` launches
``csrc/nerf_mlp.cu``; on a CPU tensor it runs :func:`nerf_mlp_plain`, the
same arithmetic in PyTorch.  Forward only: the renderer's gradient is the
autograd of its own chain (``models/render/nerf.py``).  The kernel's bf16
weight copies are cached per weight version (:func:`kernel_weights`).
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
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
    lib.nerf_mlp.argtypes = [P, I, I, I, P, P, P, P, P]
    lib.nerf_mlp.restype = I
    lib.nerf_mlp_rows.argtypes = []
    lib.nerf_mlp_rows.restype = I
    lib.nerf_mlp_cluster_blocks.argtypes = [I]
    lib.nerf_mlp_cluster_blocks.restype = I
    lib.nerf_mlp_max_clusters.argtypes = [I, P]
    lib.nerf_mlp_max_clusters.restype = I
    lib.nerf_mlp_weights.argtypes = [P, P, P, P, P, P, I, I, P, P, P]
    lib.nerf_mlp_weights.restype = I
    lib._d3_bound = True


# kernel_weights' cache: the source weights (held, so their storage cannot
# be reused while an entry lives) and the kernel's copies, newest last
_CACHE_SIZE = 4
_weight_cache: "OrderedDict[tuple, Tuple[Weights, torch.Tensor, torch.Tensor]]" = OrderedDict()
_cache_lock = threading.Lock()


def _weight_key(w: Weights) -> tuple:
    return tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device) for t in w)


def kernel_weights(w: Weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's weights: ``(wt [6D, D] bf16, eo_col [D] bf16)`` -- the
    transposes of E1, E2, EO[:, :D], D1, D2, DO stacked (row ``o*D + j``
    is column ``j`` of layer ``o``, K contiguous, as the kernel's TMA boxes
    and wgmma read them) and EO's density column, rounded to bf16 as the
    TPU kernel's wrapper rounds its weights.  On the card one launch of
    ``nerf_mlp_weights`` makes them (a tiled transpose through shared
    memory), on the CPU PyTorch copies.

    Made once per weight version and cached: the key is each weight's
    storage, ``_version``, shape, dtype and device, so an in-place update
    (an optimizer step) gives fresh copies at the next call, and a weight
    replaced by a new tensor is a new key."""
    key = _weight_key(w)
    with _cache_lock:
        hit = _weight_cache.get(key)
        if hit is not None:
            _weight_cache.move_to_end(key)
            return hit[1], hit[2]
    D = w[0].shape[0]
    if w[0].is_cuda:   # one launch of csrc/nerf_mlp.cu's weight kernel
        src = [t.contiguous() for t in w]
        if any(t.dtype != src[0].dtype for t in src) or src[0].dtype not in (
                torch.float32, torch.bfloat16):
            src = [t.to(torch.float32) for t in src]
        wt = torch.empty((6 * D, D), dtype=torch.bfloat16, device=w[0].device)
        eo_col = torch.empty((D,), dtype=torch.bfloat16, device=w[0].device)
        lib = kernels.library("nerf_mlp")
        _bind(lib)
        kernels.check(lib.nerf_mlp_weights(*(t.data_ptr() for t in src), D,
                                           int(src[0].dtype == torch.float32), wt.data_ptr(),
                                           eo_col.data_ptr(), kernels.stream_ptr(w[0])),
                      "nerf_mlp_weights")
    else:
        wt = torch.empty((6 * D, D), dtype=torch.bfloat16)
        for i, t in enumerate(w):
            wt[i * D:(i + 1) * D].copy_(t[:, :D].t())
        eo_col = w[2][:, D].to(torch.bfloat16)
    with _cache_lock:
        _weight_cache[key] = (tuple(w), wt, eo_col)
        while len(_weight_cache) > _CACHE_SIZE:
            _weight_cache.popitem(last=False)
    return wt, eo_col


def nerf_mlp_cuda(x: torch.Tensor, *w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel C (``csrc/nerf_mlp.cu``) on CUDA tensors.

    ``x`` goes in as it is when f32 or bf16 (the kernel rounds it to bf16);
    the weights through :func:`kernel_weights`."""
    _check_args(x, w)
    N, D = x.shape
    kernels.require(all(t.is_cuda and t.device == x.device for t in (x, *w)),
                    "nerf_mlp: every tensor must be on the same CUDA device")
    kernels.require(D % 128 == 0 and 128 <= D <= 1024,
                    "nerf_mlp: the kernel takes D = 128..1024 in steps of 128")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    kernels.require(x.data_ptr() % 16 == 0, "nerf_mlp: x must be 16-byte aligned")
    wt, eo_col = kernel_weights(w)
    lib = kernels.library("nerf_mlp")
    _bind(lib)
    out = torch.empty((N, D), dtype=torch.bfloat16, device=x.device)
    density = torch.empty((N,), dtype=torch.bfloat16, device=x.device)
    rc = lib.nerf_mlp(x.data_ptr(), int(x.dtype == torch.float32), N, D, wt.data_ptr(),
                      eo_col.data_ptr(), out.data_ptr(), density.data_ptr(),
                      kernels.stream_ptr(x))
    kernels.check(rc, "nerf_mlp")
    kernels.count(kernels.launches, "nerf_mlp")
    return out, density


def fused_nerf_mlp(x: torch.Tensor, *w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return nerf_mlp_cuda(x, *w)
    return nerf_mlp_plain(x, *w)
