"""Packed int4 weights and the int4 matvec (kernel A).

Port of ``ops/pallas_int4.py``: :class:`Int4Weight` in the flat biased-lo
layout, :func:`pack_int4` (bit-identical q values, bytes and scales) and
:func:`int4_matvec`, the matvec with an optional rmsnorm prologue and a
residual or SwiGLU epilogue.  On a CUDA tensor :func:`int4_matvec` launches
``csrc/int4_matvec.cu``; on a CPU tensor it runs :func:`int4_matvec_plain`,
the same arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dynam3d_torch.ops import kernels

EPILOGUES = {"store": 0, "residual": 1, "swiglu": 2}
MAX_ROWS = 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Int4Weight:
    """Packed int4 weight: ``q4`` int8 ``[Dp, N2]`` (lo nibble = first
    column half stored +8, hi nibble = second half, signed) and f32 scales
    ``s_lo``/``s_hi`` ``[Dp/dblk, N2]``; ``d``/``n`` is the unpadded shape."""

    def __init__(self, q4, s_lo, s_hi, d: int, n: int, dblk: int, nblk: int):
        self.q4 = q4
        self.s_lo = s_lo
        self.s_hi = s_hi
        self.d = d
        self.n = n
        self.dblk = dblk
        self.nblk = nblk

    @property
    def n2(self) -> int:
        return self.q4.shape[1]

    @property
    def dp(self) -> int:
        return self.q4.shape[0]

    def to(self, device) -> "Int4Weight":
        return Int4Weight(
            self.q4.to(device), self.s_lo.to(device), self.s_hi.to(device),
            self.d, self.n, self.dblk, self.nblk,
        )


def pack_int4(w: torch.Tensor, dblk: int = 1024, nblk: int = 512) -> Int4Weight:
    """Quantize ``w [D, N]`` to packed int4 with group-``dblk`` scales:
    per (group, column) scale ``max|w| / 7`` (floor 1e-8), q = round half
    to even of ``w / scale`` clipped to [-7, 7]; lo = first column half,
    hi = second, byte ``16*hi + (lo + 8)``."""
    d, n = w.shape
    dp, np_ = _round_up(d, dblk), _round_up(n, 2 * nblk)
    wf = torch.zeros((dp, np_), dtype=torch.float32, device=w.device)
    wf[:d, :n] = w.to(torch.float32)
    g = dp // dblk
    grp = wf.view(g, dblk, np_)
    scale = torch.clamp(grp.abs().amax(dim=1) / 7.0, min=1e-8)       # [G, Np]
    q = torch.clamp(torch.round(grp / scale[:, None, :]), -7, 7)
    q = q.to(torch.int32).view(dp, np_)
    del grp, wf
    n2 = np_ // 2
    lo, hi = q[:, :n2], q[:, n2:]
    packed = ((hi & 0xF) << 4) | ((lo + 8) & 0xF)                   # 0..255
    packed = torch.where(packed >= 128, packed - 256, packed).to(torch.int8)
    return Int4Weight(
        packed.contiguous(), scale[:, :n2].contiguous(),
        scale[:, n2:].contiguous(), d, n, dblk, nblk,
    )


def unpack_nibbles(q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased-lo packed bytes -> (lo, hi) signed int32 nibbles."""
    qi = q4.to(torch.int32)
    return (qi & 15) - 8, qi >> 4


def rms_normalize(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 rmsnorm times weight, rounded to bf16 (the kernels' prologue)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(torch.bfloat16)


def _check_args(x, w, ln_w, residual, epilogue):
    kernels.require(x.dim() == 2, "int4_matvec: x must be [rows, d]")
    rows, d = x.shape
    kernels.require(1 <= rows <= MAX_ROWS, f"int4_matvec: rows must be 1..{MAX_ROWS}")
    kernels.require(d <= w.dp, "int4_matvec: x is wider than the packed weight")
    kernels.require(x.dtype in (torch.bfloat16, torch.float32),
                    "int4_matvec: x must be bf16 or f32")
    kernels.require(epilogue in EPILOGUES, f"int4_matvec: unknown epilogue {epilogue}")
    if epilogue == "swiglu":
        kernels.require(w.n == 2 * w.n2, "int4_matvec: swiglu needs n == 2*n2")
    if epilogue == "residual":
        kernels.require(residual is not None and residual.shape == (rows, w.n),
                        "int4_matvec: residual must be [rows, n]")
    if ln_w is not None:
        kernels.require(ln_w.shape == (d,) and ln_w.dtype == torch.float32,
                        "int4_matvec: ln_w must be f32 [d]")


def _out_shape(rows: int, w: Int4Weight, epilogue: str) -> Tuple[int, int]:
    return (rows, w.n2 if epilogue == "swiglu" else w.n)


def int4_matvec_plain(
    x: torch.Tensor, w: Int4Weight, *, ln_w: Optional[torch.Tensor] = None,
    eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
    epilogue: str = "store", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """PyTorch version of kernel A: the same arithmetic, any device.

    x -> (rmsnorm * ln_w if given) -> bf16; per dblk-row group the exact
    integer-nibble products are summed in f32, then scaled by the group
    scale; groups are summed in f32; then the epilogue."""
    _check_args(x, w, ln_w, residual, epilogue)
    if x.is_cuda:
        kernels.plain_calls["int4_matvec"] += 1
    rows, d = x.shape
    xb = rms_normalize(x, ln_w, eps) if ln_w is not None else x.to(torch.bfloat16)
    xf = torch.zeros((rows, w.dp), dtype=torch.float32, device=x.device)
    xf[:, :d] = xb.to(torch.float32)
    lo, hi = unpack_nibbles(w.q4)
    g = w.dp // w.dblk
    xg = xf.view(rows, g, w.dblk).transpose(0, 1)                  # [G, R, dblk]

    def half(q, s):
        qg = q.to(torch.float32).view(g, w.dblk, w.n2)
        return (torch.bmm(xg, qg) * s[:, None, :]).sum(dim=0)     # [R, N2]

    y_lo, y_hi = half(lo, w.s_lo), half(hi, w.s_hi)
    if epilogue == "swiglu":
        y = y_lo * torch.sigmoid(y_lo) * y_hi
    else:
        y = torch.cat([y_lo, y_hi], dim=-1)[:, : w.n]
        if epilogue == "residual":
            y = y + residual.to(torch.float32)
    return y.to(out_dtype)


# cached zeroed ticket buffers, one per device (each launch leaves them zero)
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def _slice_rows(w: Int4Weight, rows: int, lib) -> int:
    """K rows per block: the largest power-of-two divisor of dblk that fits
    the staged-x buffer while the grid still has >= 2 blocks per SM."""
    tile = lib.int4_matvec_tile()
    ks = w.dblk
    cap = lib.int4_matvec_max_slice(rows)
    while ks > cap and ks % 2 == 0:
        ks //= 2
    n_tiles = -(-w.n2 // tile)
    sms = torch.cuda.get_device_properties(w.q4.device).multi_processor_count
    while n_tiles * (w.dp // ks) < 2 * sms and ks % 2 == 0 and ks > 128:
        ks //= 2
    kernels.require(w.dblk % ks == 0 and ks <= cap,
                    f"int4_matvec: no K slice fits dblk={w.dblk}")
    return ks


def _bind(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int4_matvec.argtypes = [
        P, I, I, I, P, F, P, P, P, I, I, I, I, P, I, I, P, I, I, P, P, P,
    ]
    lib.int4_matvec.restype = I
    lib.int4_matvec_tile.argtypes = []
    lib.int4_matvec_tile.restype = I
    lib.int4_matvec_max_slice.argtypes = [I]
    lib.int4_matvec_max_slice.restype = I
    lib._d3_bound = True


def int4_matvec_cuda(
    x: torch.Tensor, w: Int4Weight, *, ln_w: Optional[torch.Tensor] = None,
    eps: float = 1e-5, residual: Optional[torch.Tensor] = None,
    epilogue: str = "store", out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Launch kernel A (``csrc/int4_matvec.cu``) on CUDA tensors."""
    _check_args(x, w, ln_w, residual, epilogue)
    tensors = [x, w.q4, w.s_lo, w.s_hi]
    tensors += [t for t in (ln_w, residual) if t is not None]
    kernels.require_cuda(tensors, "int4_matvec")
    kernels.require(w.q4.dtype == torch.int8 and w.s_lo.dtype == torch.float32,
                    "int4_matvec: q4 must be int8 and scales f32")
    kernels.require(w.n2 % 4 == 0, "int4_matvec: n2 must be a multiple of 4")
    kernels.require(out_dtype in (torch.bfloat16, torch.float32),
                    "int4_matvec: out_dtype must be bf16 or f32")
    if residual is not None:
        kernels.require(residual.dtype in (torch.bfloat16, torch.float32),
                        "int4_matvec: residual must be bf16 or f32")
    lib = kernels.library("int4_matvec")
    _bind(lib)
    rows, d = x.shape
    ks = _slice_rows(w, rows, lib)
    nsplit = w.dp // ks
    out = torch.empty(_out_shape(rows, w, epilogue), dtype=out_dtype, device=x.device)
    ws = (torch.empty(nsplit * rows * 2 * w.n2, dtype=torch.float32, device=x.device)
          if nsplit > 1 else None)
    tickets = _ticket_buffer(x.device, -(-w.n2 // lib.int4_matvec_tile()))
    rc = lib.int4_matvec(
        x.data_ptr(), int(x.dtype == torch.float32), rows, d,
        ln_w.data_ptr() if ln_w is not None else None, float(eps),
        w.q4.data_ptr(), w.s_lo.data_ptr(), w.s_hi.data_ptr(), w.dp, w.n2,
        w.dblk, ks,
        residual.data_ptr() if residual is not None else None,
        int(residual is not None and residual.dtype == torch.float32),
        EPILOGUES[epilogue], out.data_ptr(), int(out_dtype == torch.float32),
        out.shape[1], ws.data_ptr() if ws is not None else None,
        tickets.data_ptr(), kernels.stream_ptr(x),
    )
    kernels.check(rc, "int4_matvec")
    kernels.launches["int4_matvec"] += 1
    return out


def int4_matvec(x: torch.Tensor, w: Int4Weight, **kw) -> torch.Tensor:
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return int4_matvec_cuda(x, w, **kw)
    return int4_matvec_plain(x, w, **kw)


def int4_matmul(x: torch.Tensor, w: Int4Weight, out_dtype=None) -> torch.Tensor:
    """``x [..., D] @ W`` against a packed int4 weight, for <= 16 rows
    (the decode regime; larger row counts use the int8 weights)."""
    lead = x.shape[:-1]
    y = int4_matvec(
        x.reshape(-1, x.shape[-1]).contiguous(), w,
        out_dtype=out_dtype or x.dtype,
    )
    return y.reshape(*lead, w.n)
