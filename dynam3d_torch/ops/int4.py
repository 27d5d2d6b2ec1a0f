"""Packed int4 weights and the int4 kernels A, E, F and G.

Port of ``ops/pallas_int4.py``: :class:`Int4Weight` in the flat biased-lo
layout, :func:`pack_int4` (bit-identical q values, bytes and scales) and
four kernels, each with a plain PyTorch version of the same arithmetic:

* A :func:`int4_matvec` (``csrc/int4_matvec.cu``): the matvec with an
  optional rmsnorm prologue and a residual or SwiGLU epilogue;
* E :func:`int4_matvec2d` (``csrc/int4_matvec2d.cu``): the 2-D-grid matvec,
  ``_pallas_int4_matmul2d``, taken by :func:`int4_matmul` under
  ``DYNAM3D_INT4_GRID2D``: A's kernel with one K slice per scale group;
* F :func:`int4_mlp` and G :func:`int4_mlp_block` (``csrc/int4_mlp.cu``):
  the fused SwiGLU MLP, ``_pallas_int4_mlp``, and the same with the rmsnorm
  prologue and the residual, ``_pallas_int4_mlp_block``.

A dispatcher takes the same route on either device, chosen by shapes and
flags as in the reference: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dynam3d_torch import flags
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
        kernels.count(kernels.plain_calls, "int4_matvec")
    return _matvec_math(x, w, ln_w, eps, residual, epilogue, out_dtype)


def _matvec_math(x, w, ln_w=None, eps=1e-5, residual=None, epilogue="store",
                 out_dtype=torch.float32):
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


def _slice_rows(w: Int4Weight, lib) -> int:
    """K rows per block: the largest power-of-two divisor of dblk that fits
    the staged-x buffer while the grid still has a block per SM, in at most
    ``int4_matvec_max_splits()`` slices (each further slice adds a round to
    the last block's ordered sum)."""
    tile = lib.int4_matvec_tile()
    ks = w.dblk
    cap = lib.int4_matvec_max_slice()
    while ks > cap and ks % 2 == 0:
        ks //= 2
    n_tiles = -(-w.n2 // tile)
    sms = torch.cuda.get_device_properties(w.q4.device).multi_processor_count
    while (n_tiles * (w.dp // ks) < sms and ks % 2 == 0 and ks > 128
           and w.dp // (ks // 2) <= lib.int4_matvec_max_splits()):
        ks //= 2
    kernels.require(w.dblk % ks == 0 and ks <= cap and ks % 64 == 0,
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
    lib.int4_matvec_max_slice.argtypes = []
    lib.int4_matvec_max_slice.restype = I
    lib.int4_matvec_max_splits.argtypes = []
    lib.int4_matvec_max_splits.restype = I
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
    kernels.require(w.n2 % 16 == 0, "int4_matvec: n2 must be a multiple of 16")
    kernels.require(out_dtype in (torch.bfloat16, torch.float32),
                    "int4_matvec: out_dtype must be bf16 or f32")
    if residual is not None:
        kernels.require(residual.dtype in (torch.bfloat16, torch.float32),
                        "int4_matvec: residual must be bf16 or f32")
    lib = kernels.library("int4_matvec")
    _bind(lib)
    rows, d = x.shape
    ks = _slice_rows(w, lib)
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
    kernels.count(kernels.launches, "int4_matvec")
    return out


def int4_matvec(x: torch.Tensor, w: Int4Weight, **kw) -> torch.Tensor:
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return int4_matvec_cuda(x, w, **kw)
    return int4_matvec_plain(x, w, **kw)


def int4_matmul(x: torch.Tensor, w: Int4Weight, out_dtype=None) -> torch.Tensor:
    """``x [..., D] @ W`` against a packed int4 weight, for <= 16 rows
    (the decode regime; larger row counts use the int8 weights): kernel A,
    or kernel E under ``DYNAM3D_INT4_GRID2D``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out_dtype = out_dtype or x.dtype
    if flags.int4_grid2d():
        y = int4_matvec2d(x2, w, out_dtype=out_dtype)
    else:
        y = int4_matvec(x2, w, out_dtype=out_dtype)
    return y.reshape(*lead, w.n)


# ---------------------------------------------------------------- kernel E

def _check_rows(x: torch.Tensor, d_max: int, name: str) -> None:
    kernels.require(x.dim() == 2, f"{name}: x must be [rows, d]")
    kernels.require(1 <= x.shape[0] <= MAX_ROWS, f"{name}: rows must be 1..{MAX_ROWS}")
    kernels.require(x.shape[1] <= d_max, f"{name}: x is wider than the packed weight")


def _unpack_shift(q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased-lo bytes -> (lo, hi) signed int32 nibbles by shifts, the TPU
    2-D kernel's unpack (the same integers as :func:`unpack_nibbles`)."""
    qi = q4.to(torch.int32)
    return (qi & 15) - 8, (qi << 24) >> 28


def int4_matvec2d_plain(x: torch.Tensor, w: Int4Weight,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PyTorch version of kernel E (any device): per scale group i the
    bf16 activations times the shift-unpacked nibbles, summed in f32 and
    scaled by the group scale; the groups summed in order i = 0..g-1."""
    _check_rows(x, w.dp, "int4_matvec2d")
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "int4_matvec2d")
    rows, d = x.shape
    xf = torch.zeros((rows, w.dp), dtype=torch.float32, device=x.device)
    xf[:, :d] = x.to(torch.bfloat16).to(torch.float32)
    lo, hi = _unpack_shift(w.q4)
    y = torch.zeros((rows, 2 * w.n2), dtype=torch.float32, device=x.device)
    for i in range(w.dp // w.dblk):
        ks = slice(i * w.dblk, (i + 1) * w.dblk)
        p_lo = (xf[:, ks] @ lo[ks].to(torch.float32)) * w.s_lo[i]
        p_hi = (xf[:, ks] @ hi[ks].to(torch.float32)) * w.s_hi[i]
        y = y + torch.cat([p_lo, p_hi], dim=-1)
    return y[:, : w.n].to(out_dtype)


def _bind_matvec2d(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.int4_matvec2d.argtypes = [P, I, I, P, P, P, I, I, I, P, I, I, P, P, P]
    lib.int4_matvec2d.restype = I
    lib.int4_matvec2d_items.argtypes = [I, I, I]
    lib.int4_matvec2d_items.restype = I
    lib.int4_matvec2d_blocks_per_sm.argtypes = [I, P]
    lib.int4_matvec2d_blocks_per_sm.restype = I
    lib._d3_bound = True


def _check_weight_cuda(w: Int4Weight, name: str) -> None:
    kernels.require(w.q4.dtype == torch.int8 and w.s_lo.dtype == torch.float32
                    and w.s_hi.dtype == torch.float32,
                    f"{name}: q4 must be int8 and scales f32")
    kernels.require(w.n2 % 4 == 0, f"{name}: n2 must be a multiple of 4")
    kernels.require(w.dp % w.dblk == 0, f"{name}: dp must be a multiple of dblk")


def _out_flag(out_dtype: torch.dtype, name: str) -> int:
    kernels.require(out_dtype in (torch.bfloat16, torch.float32),
                    f"{name}: out_dtype must be bf16 or f32")
    return int(out_dtype == torch.float32)


def int4_matvec2d_cuda(x: torch.Tensor, w: Int4Weight,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch kernel E (``csrc/int4_matvec2d.cu``) on CUDA tensors: the
    tensor-core body of ``csrc/int4_mma.cuh`` with one K slice per scale
    group, so it takes what that body takes (``n2 % 16 == 0``, a 16-byte
    aligned ``q4``, ``dblk`` a multiple of 64 up to 1024) and raises on the
    rest."""
    _check_rows(x, w.dp, "int4_matvec2d")
    kernels.require_cuda([x, w.q4, w.s_lo, w.s_hi], "int4_matvec2d")
    _check_weight_cuda(w, "int4_matvec2d")
    kernels.require(w.n2 % 16 == 0 and w.q4.data_ptr() % 16 == 0,
                    "int4_matvec2d: n2 must be a multiple of 16 and q4 16-byte aligned")
    kernels.require(w.dblk % 64 == 0 and w.dblk <= 1024,
                    "int4_matvec2d: dblk must be a multiple of 64, at most 1024")
    out_f32 = _out_flag(out_dtype, "int4_matvec2d")
    lib = kernels.library("int4_matvec2d")
    _bind_matvec2d(lib)
    xb = x.to(torch.bfloat16).contiguous()
    rows, d = x.shape
    g = w.dp // w.dblk
    out = torch.empty((rows, w.n), dtype=out_dtype, device=x.device)
    ws = torch.empty(g * rows * 2 * w.n2, dtype=torch.float32, device=x.device)
    tickets = _ticket_buffer(x.device, _tiles(w.n2))
    rc = lib.int4_matvec2d(
        xb.data_ptr(), rows, d, w.q4.data_ptr(), w.s_lo.data_ptr(), w.s_hi.data_ptr(),
        w.dp, w.n2, w.dblk, out.data_ptr(), out_f32, w.n, ws.data_ptr(),
        tickets.data_ptr(), kernels.stream_ptr(x),
    )
    kernels.check(rc, "int4_matvec2d")
    kernels.count(kernels.launches, "int4_matvec2d")
    return out


def int4_matvec2d(x: torch.Tensor, w: Int4Weight, **kw) -> torch.Tensor:
    """Kernel E on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return int4_matvec2d_cuda(x, w, **kw)
    return int4_matvec2d_plain(x, w, **kw)


def _tiles(n2: int) -> int:
    return -(-n2 // 128)       # 128 packed columns per tile in kernels A and E-H


# ------------------------------------------------------------ kernels F, G

def _rows_of(x: torch.Tensor) -> int:
    n = 1
    for s in x.shape[:-1]:
        n *= s
    return n


def _mlp_eligible(rows: int, gate_up: Int4Weight, down: Int4Weight) -> bool:
    """Shapes kernel F takes (``pallas_int4.int4_mlp``): the lo | hi halves
    of gate_up are exactly gate | up only without column padding."""
    return (rows <= MAX_ROWS and gate_up.nblk == down.nblk
            and gate_up.dblk == down.dblk and gate_up.n == 2 * gate_up.n2)


def _mlp_block_eligible(rows: int, d: int, gate_up: Int4Weight, down: Int4Weight) -> bool:
    """Kernel G additionally needs unpadded widths (``int4_mlp_block``)."""
    return (_mlp_eligible(rows, gate_up, down) and down.n == 2 * down.n2
            and gate_up.d == d == down.n and gate_up.dp == d)


def _check_mlp(x, gate_up, down, name):
    _check_rows(x, gate_up.dp, name)
    kernels.require(_mlp_eligible(x.shape[0], gate_up, down),
                    f"{name}: gate_up/down packs are not fused-MLP shaped")
    kernels.require(down.dp >= gate_up.n2, f"{name}: down has fewer rows than gate_up columns")


def _swiglu_down(xn, gate_up, down, residual, out_dtype):
    h = _matvec_math(xn, gate_up, epilogue="swiglu", out_dtype=torch.bfloat16)
    if residual is None:
        return _matvec_math(h, down, out_dtype=out_dtype)
    return _matvec_math(h, down, residual=residual, epilogue="residual", out_dtype=out_dtype)


def int4_mlp_plain(x: torch.Tensor, gate_up: Int4Weight, down: Int4Weight,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PyTorch version of kernel F (any device): ``h = silu(gate) * up`` in
    f32 from the bf16 activations, rounded to bf16, then the down matvec;
    ``x [rows, d]`` -> ``[rows, down.n]``."""
    _check_mlp(x, gate_up, down, "int4_mlp")
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "int4_mlp")
    return _swiglu_down(x.to(torch.bfloat16), gate_up, down, None, out_dtype)


def int4_mlp_block_plain(x: torch.Tensor, ln_w: torch.Tensor, gate_up: Int4Weight,
                         down: Int4Weight, eps: float,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PyTorch version of kernel G (any device): ``x + F(bf16(rmsnorm(x) *
    ln_w))`` with the residual added in f32."""
    _check_mlp(x, gate_up, down, "int4_mlp_block")
    kernels.require(_mlp_block_eligible(x.shape[0], x.shape[1], gate_up, down),
                    "int4_mlp_block: widths must be unpadded")
    if x.is_cuda:
        kernels.count(kernels.plain_calls, "int4_mlp_block")
    xb = x.to(torch.bfloat16)
    xn = rms_normalize(xb, ln_w, eps)
    return _swiglu_down(xn, gate_up, down, xb, out_dtype)


def _bind_mlp(lib) -> None:
    if getattr(lib, "_d3_bound", False):
        return
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.int4_mlp_plan.argtypes = [I, I, I, I, I, I, P]
    lib.int4_mlp_plan.restype = I
    lib.int4_mlp.argtypes = [P, I, I, P, P, P, I, I, P, P, P, I, I, I, I, I, I, I, P, P, I,
                             P, P, P, P]
    lib.int4_mlp.restype = I
    lib.int4_mlp_block.argtypes = [P, I, I, P, F, P, P, P, I, I, P, P, P, I, I, I, I, I, I,
                                   P, P, I, P, P, P, P]
    lib.int4_mlp_block.restype = I
    lib._d3_bound = True


_plans: Dict[tuple, Tuple[int, int, int]] = {}


def plan(lib, fn: str, device: torch.device, *shape: int) -> Tuple[int, int, int]:
    """``(grid, ks_a, ks_b)`` of a cooperative kernel from its ``*_plan``
    entry: the blocks the card holds at once and the K slices of its two
    matvec phases; cached per shape and device."""
    key = (fn, device) + shape
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        kernels.check(getattr(lib, fn)(*shape, out), fn)
        got = _plans[key] = (out[0], out[1], out[2])
    return got


def _mlp_launch(x, ln_w, eps, gate_up, down, out_dtype, name):
    tensors = [x, gate_up.q4, gate_up.s_lo, gate_up.s_hi, down.q4, down.s_lo, down.s_hi]
    kernels.require_cuda(tensors + ([ln_w] if ln_w is not None else []), name)
    _check_weight_cuda(gate_up, name)
    _check_weight_cuda(down, name)
    out_f32 = _out_flag(out_dtype, name)
    lib = kernels.library("int4_mlp")
    _bind_mlp(lib)
    xb = x.to(torch.bfloat16).contiguous()
    rows, d = x.shape
    grid, ks1, ks2 = plan(lib, "int4_mlp_plan", x.device, rows, gate_up.dp, gate_up.n2, down.dp,
                          down.n2, gate_up.dblk)
    dev = x.device
    h = torch.empty((rows, gate_up.n2), dtype=torch.bfloat16, device=dev)
    ws1 = torch.empty((gate_up.dp // ks1) * rows * 2 * gate_up.n2, dtype=torch.float32,
                      device=dev)
    ws2 = torch.empty((down.dp // ks2) * rows * 2 * down.n2, dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, _tiles(gate_up.n2) + _tiles(down.n2))
    common = (gate_up.q4.data_ptr(), gate_up.s_lo.data_ptr(), gate_up.s_hi.data_ptr(),
              gate_up.dp, gate_up.n2, down.q4.data_ptr(), down.s_lo.data_ptr(),
              down.s_hi.data_ptr(), down.dp, down.n2)
    tail = (gate_up.dblk, grid, ks1, ks2, h.data_ptr())
    if ln_w is None:
        out = torch.empty((rows, down.n), dtype=out_dtype, device=dev)
        rc = lib.int4_mlp(xb.data_ptr(), rows, d, *common, down.n, *tail, out.data_ptr(),
                          out_f32, ws1.data_ptr(), ws2.data_ptr(), tickets.data_ptr(),
                          kernels.stream_ptr(x))
    else:
        kernels.require(ln_w.shape == (d,) and ln_w.dtype == torch.float32,
                        f"{name}: ln_w must be f32 [d]")
        out = torch.empty((rows, d), dtype=out_dtype, device=dev)
        rc = lib.int4_mlp_block(xb.data_ptr(), rows, d, ln_w.data_ptr(), float(eps), *common,
                                *tail, out.data_ptr(), out_f32, ws1.data_ptr(),
                                ws2.data_ptr(), tickets.data_ptr(), kernels.stream_ptr(x))
    kernels.check(rc, name)
    kernels.count(kernels.launches, name)
    return out


def int4_mlp_cuda(x: torch.Tensor, gate_up: Int4Weight, down: Int4Weight,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch kernel F (``csrc/int4_mlp.cu``, one cooperative launch)."""
    _check_mlp(x, gate_up, down, "int4_mlp")
    return _mlp_launch(x, None, 0.0, gate_up, down, out_dtype, "int4_mlp")


def int4_mlp_block_cuda(x: torch.Tensor, ln_w: torch.Tensor, gate_up: Int4Weight,
                        down: Int4Weight, eps: float,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch kernel G (``csrc/int4_mlp.cu``, one cooperative launch)."""
    _check_mlp(x, gate_up, down, "int4_mlp_block")
    kernels.require(_mlp_block_eligible(x.shape[0], x.shape[1], gate_up, down),
                    "int4_mlp_block: widths must be unpadded")
    return _mlp_launch(x, ln_w, eps, gate_up, down, out_dtype, "int4_mlp_block")


def int4_mlp(x: torch.Tensor, gate_up: Int4Weight, down: Int4Weight,
             out_dtype=None) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))`` over packed int4 weights
    (``pallas_int4.int4_mlp``).  Eligible packs take kernel F (its plain
    version on a CPU tensor); other packs run the reference's chain: gate
    and up in f32 through :func:`int4_matmul`, SwiGLU in f32 rounded to
    ``x``'s type, re-padded to ``down.dp`` rows, then the down matmul."""
    lead = x.shape[:-1]
    rows = _rows_of(x)
    out_dtype = out_dtype or x.dtype
    if not _mlp_eligible(rows, gate_up, down):
        gu = int4_matmul(x, gate_up, out_dtype=torch.float32)
        gate, up = gu.chunk(2, dim=-1)
        h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
        pad = down.dp - h.shape[-1]
        if pad:
            h = torch.cat([h, h.new_zeros(*h.shape[:-1], pad)], dim=-1)
        return int4_matmul(h, down, out_dtype=out_dtype)
    x2 = x.reshape(rows, x.shape[-1])
    fn = int4_mlp_cuda if x.is_cuda else int4_mlp_plain
    return fn(x2, gate_up, down, out_dtype=out_dtype).reshape(*lead, down.n)


def int4_mlp_block(x: torch.Tensor, ln_w: torch.Tensor, gate_up: Int4Weight,
                   down: Int4Weight, eps: float, out_dtype=None) -> torch.Tensor:
    """``x + down(silu(gate(rmsnorm(x))) * up(rmsnorm(x)))``
    (``pallas_int4.int4_mlp_block``): kernel G on eligible packs, else the
    reference's chain rmsnorm -> :func:`int4_mlp` -> f32 residual add."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    rows = _rows_of(x)
    out_dtype = out_dtype or x.dtype
    if not _mlp_block_eligible(rows, d, gate_up, down):
        h = rms_normalize(x, ln_w, eps)
        y = x.to(torch.float32) + int4_mlp(h, gate_up, down, out_dtype=torch.float32)
        return y.to(out_dtype)
    x2 = x.reshape(rows, d)
    fn = int4_mlp_block_cuda if x.is_cuda else int4_mlp_block_plain
    return fn(x2, ln_w, gate_up, down, eps, out_dtype=out_dtype).reshape(*lead, d)
