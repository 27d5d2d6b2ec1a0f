"""The streamed int4 matvec of the int4 microbenchmarks (kernels I and J).

Port of the two Pallas kernels of ``tools/bench_int4_stream.py`` (I) and
``tools/bench_int4_unpack.py`` (J): for each of ``NW`` stacked packed weights
``q4 [NW, D, N2]`` (``pack_int4``'s flat layout, scales ``[NW, D/dblk, N2]``)
and 8 activation rows ``x [8, D]``, ``y[w] = x @ dequant(q4[w])`` as
``[8, 2*N2]`` (lo half | hi half), the weight streamed through a ring of ``S``
slots of ``nblk`` packed columns (``csrc/int4_stream.cu``).

* I :func:`int4_stream_matvec`: the body of ``nibble_matvec_acc``, the
  biased-lo AND form; ``S`` and ``nblk`` are the swept ring depth and tile
  width.
* J :func:`int4_unpack_matvec`: ``S = 2``, ``nblk = 512`` and one of four
  bodies: ``dma-floor`` (``y[w, r, c] = q4[w, r, c]`` for the lo half, zero
  hi half), ``current`` (signed-lo bytes, ``q4 ^ 8``, shift unpack),
  ``andtrick`` (I's body), ``w4a8`` (int8 ``x``, int32 sums).

The TPU kernels leave the last weight's result in one ``[8, N]`` output; here
``y`` has all ``NW``, and the tools read ``y[NW - 1]``.  Each kernel has a
plain PyTorch version of the same arithmetic; the dispatchers launch the
kernel on a CUDA tensor and run the plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from dynam3d_torch.ops import kernels
from dynam3d_torch.ops.int4 import _ticket_buffer

ROWS = 8                       # activation rows (the tools' BP)
STREAM_VARIANTS = ((2, 512), (3, 512), (4, 512), (4, 256), (6, 256), (8, 128))  # (S, nblk)
UNPACK_BODIES = ("dma-floor", "current", "andtrick", "w4a8")
UNPACK_S, UNPACK_NBLK = 2, 512
RING_BYTES = 64 * 1024         # a block's ring: two blocks fit on an SM
_BODY_IDS = {"andtrick": 0, "dma-floor": 1, "current": 2, "w4a8": 3}


def stage_rows(S: int, nblk: int, dblk: int) -> int:
    """kc, the weight rows of one ring slot: the largest power of two that
    divides ``dblk`` with ``S * kc * nblk <= RING_BYTES``."""
    kc = 1
    while S * 2 * kc * nblk <= RING_BYTES and dblk % (2 * kc) == 0:
        kc *= 2
    kernels.require(kc >= ROWS, f"int4_stream: S={S}, nblk={nblk} leave a slot under 8 rows")
    return kc


def split_rows(nw: int, d: int, n2: int, dblk: int, nblk: int, kc: int, sms: int) -> int:
    """kslice, the weight rows of one block: ``dblk`` halved while the grid
    of (weight, column tile, K slice) blocks has fewer than two per SM."""
    ks = dblk
    while nw * (n2 // nblk) * (d // ks) < 2 * sms and ks % (2 * kc) == 0:
        ks //= 2
    return ks


def _check(x, q4, s_lo, s_hi, dblk, nblk, name):
    kernels.require(q4.dim() == 3 and q4.dtype == torch.int8, f"{name}: q4 must be int8 [NW, D, N2]")
    nw, d, n2 = q4.shape
    kernels.require(tuple(x.shape) == (ROWS, d), f"{name}: x must be [{ROWS}, D]")
    kernels.require(d % dblk == 0 and n2 % nblk == 0,
                    f"{name}: D must be a multiple of dblk and N2 of nblk")
    for s in (s_lo, s_hi):
        kernels.require(tuple(s.shape) == (nw, d // dblk, n2) and s.dtype == torch.float32,
                        f"{name}: scales must be f32 [NW, D/dblk, N2]")


def _group_products(x, q4, dblk, dtype):
    """Per scale group, ``x`` times the bytes and times their low nibbles
    (``b & 15``): ``[NW, G, rows, N2]`` each, in ``dtype``."""
    nw, d, n2 = q4.shape
    g = d // dblk
    xg = x.to(dtype).view(ROWS, g, dblk).transpose(0, 1)             # [G, R, dblk]
    b = q4.view(nw, g, dblk, n2)
    return xg, torch.matmul(xg, b.to(dtype)), torch.matmul(xg, (b & 15).to(dtype))


def _and_form(x, q4, s_lo, s_hi, dblk):
    """The biased-lo AND form in f32 (kernel I; J's andtrick)."""
    xg, p_b, p_lo = _group_products(x.to(torch.bfloat16), q4, dblk, torch.float32)
    sumx = xg.sum(-1, keepdim=True)                                    # [G, R, 1]
    lo = ((p_lo - 8.0 * sumx) * s_lo[:, :, None, :]).sum(1)
    hi = ((p_b - p_lo) * (0.0625 * s_hi)[:, :, None, :]).sum(1)
    return torch.cat([lo, hi], -1)


def int4_stream_matvec_plain(x, q4, s_lo, s_hi, *, dblk: int = 1024,
                             nblk: int = 512) -> torch.Tensor:
    """PyTorch version of kernel I (any device): ``[NW, 8, 2*N2]`` f32."""
    _check(x, q4, s_lo, s_hi, dblk, nblk, "int4_stream_matvec")
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "int4_stream_matvec")
    return _and_form(x, q4, s_lo, s_hi, dblk)


def int4_unpack_matvec_plain(x, q4, s_lo, s_hi, *, body: str, dblk: int = 1024,
                             nblk: int = UNPACK_NBLK) -> torch.Tensor:
    """PyTorch version of kernel J (any device), ``body`` as in
    :data:`UNPACK_BODIES`; ``current`` reads signed-lo bytes (``q4 ^ 8``),
    ``w4a8`` int8 ``x`` (its int32 sums exact, in float64 here)."""
    kernels.require(body in _BODY_IDS, f"int4_unpack_matvec: unknown body {body!r}")
    _check(x, q4, s_lo, s_hi, dblk, nblk, "int4_unpack_matvec")
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "int4_unpack_matvec")
    nw, d, n2 = q4.shape
    if body == "dma-floor":
        y = torch.zeros((nw, ROWS, 2 * n2), dtype=torch.float32, device=q4.device)
        y[:, :, :n2] = q4[:, :ROWS].to(torch.float32)
        return y
    if body == "andtrick":
        return _and_form(x, q4, s_lo, s_hi, dblk)
    if body == "current":
        g = d // dblk
        xg = x.to(torch.bfloat16).to(torch.float32).view(ROWS, g, dblk).transpose(0, 1)
        qi = q4.to(torch.int32).view(nw, g, dblk, n2)
        lo = torch.matmul(xg, ((qi << 28) >> 28).to(torch.float32))
        hi = torch.matmul(xg, ((qi << 24) >> 28).to(torch.float32))
        return torch.cat([(lo * s_lo[:, :, None, :]).sum(1), (hi * s_hi[:, :, None, :]).sum(1)], -1)
    kernels.require(x.dtype == torch.int8, "int4_unpack_matvec: w4a8 takes int8 x")
    xg, p_b, p_lo = _group_products(x, q4, dblk, torch.float64)
    sumx = xg.sum(-1, keepdim=True)
    lo = ((p_lo - 8 * sumx).to(torch.float32) * s_lo[:, :, None, :]).sum(1)
    hi = ((p_b - p_lo).to(torch.float32) * (0.0625 * s_hi)[:, :, None, :]).sum(1)
    return torch.cat([lo, hi], -1)


def _bind(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I = ctypes.c_void_p, ctypes.c_int
    tail = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.int4_stream_matvec.argtypes = tail
    lib.int4_stream_matvec.restype = I
    lib.int4_unpack_matvec.argtypes = [I] + tail
    lib.int4_unpack_matvec.restype = I
    lib._d3_bound = True


_sms: Dict[torch.device, int] = {}


def plan(q4: torch.Tensor, S: int, nblk: int, dblk: int):
    """``(kc, kslice)`` of a launch on ``q4``'s card."""
    nw, d, n2 = q4.shape
    sms = _sms.get(q4.device)
    if sms is None:
        sms = _sms[q4.device] = torch.cuda.get_device_properties(q4.device).multi_processor_count
    kc = stage_rows(S, nblk, dblk)
    return kc, split_rows(nw, d, n2, dblk, nblk, kc, sms)


def _launch(name, body, x, q4, s_lo, s_hi, S, nblk, dblk):
    kernels.require_cuda([x, q4, s_lo, s_hi], name)
    nw, d, n2 = q4.shape
    kc, kslice = plan(q4, S, nblk, dblk)
    nsplit = d // kslice
    y = torch.empty((nw, ROWS, 2 * n2), dtype=torch.float32, device=q4.device)
    ws = (torch.empty((nw, nsplit, ROWS, 2 * n2), dtype=torch.float32, device=q4.device)
          if nsplit > 1 and body != "dma-floor" else None)
    tickets = _ticket_buffer(q4.device, nw * (n2 // nblk))
    lib = kernels.library("int4_stream")
    _bind(lib)
    args = (x.data_ptr(), q4.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, tickets.data_ptr(), nw, d, n2, dblk,
            nblk, S, kc, kslice, kernels.stream_ptr(x))
    if name == "int4_stream_matvec":
        rc = lib.int4_stream_matvec(*args)
    else:
        rc = lib.int4_unpack_matvec(_BODY_IDS[body], *args)
    kernels.check(rc, name)
    kernels.count(kernels.launches, name)
    return y


def int4_stream_matvec_cuda(x, q4, s_lo, s_hi, *, S: int, nblk: int,
                            dblk: int = 1024) -> torch.Tensor:
    """Launch kernel I (``csrc/int4_stream.cu``) on CUDA tensors."""
    _check(x, q4, s_lo, s_hi, dblk, nblk, "int4_stream_matvec")
    kernels.require(x.dtype == torch.bfloat16, "int4_stream_matvec: x must be bf16")
    return _launch("int4_stream_matvec", "andtrick", x, q4, s_lo, s_hi, S, nblk, dblk)


def int4_unpack_matvec_cuda(x, q4, s_lo, s_hi, *, body: str, dblk: int = 1024,
                            nblk: int = UNPACK_NBLK) -> torch.Tensor:
    """Launch kernel J (``csrc/int4_stream.cu``) with ``body`` on CUDA tensors."""
    kernels.require(body in _BODY_IDS, f"int4_unpack_matvec: unknown body {body!r}")
    _check(x, q4, s_lo, s_hi, dblk, nblk, "int4_unpack_matvec")
    want = torch.int8 if body == "w4a8" else torch.bfloat16
    kernels.require(x.dtype == want, f"int4_unpack_matvec: {body} takes {want} x")
    return _launch("int4_unpack_matvec", body, x, q4, s_lo, s_hi, UNPACK_S, nblk, dblk)


def int4_stream_matvec(x, q4, s_lo, s_hi, *, S: int, nblk: int, dblk: int = 1024):
    """Kernel I on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return int4_stream_matvec_cuda(x, q4, s_lo, s_hi, S=S, nblk=nblk, dblk=dblk)
    return int4_stream_matvec_plain(x, q4, s_lo, s_hi, dblk=dblk, nblk=nblk)


def int4_unpack_matvec(x, q4, s_lo, s_hi, *, body: str, dblk: int = 1024,
                       nblk: int = UNPACK_NBLK):
    """Kernel J on a CUDA tensor, its plain version on a CPU tensor."""
    fn = int4_unpack_matvec_cuda if x.is_cuda else int4_unpack_matvec_plain
    return fn(x, q4, s_lo, s_hi, body=body, dblk=dblk, nblk=nblk)
