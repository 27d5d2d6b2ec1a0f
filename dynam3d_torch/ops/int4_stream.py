"""The streamed int4 matvec of the int4 microbenchmarks (kernels I and J).

Port of the two Pallas kernels of ``tools/bench_int4_stream.py`` (I) and
``tools/bench_int4_unpack.py`` (J): for each of ``NW`` stacked packed weights
``q4 [NW, D, N2]`` (``pack_int4``'s flat layout, scales ``[NW, D/dblk, N2]``)
and 8 activation rows ``x [8, D]``, ``y[w] = x @ dequant(q4[w])`` as
``[8, 2*N2]`` (lo half | hi half), on the tensor-core body of kernels A, E, F
and G (``csrc/int4_stream.cu`` on ``csrc/int4_mma.cuh``): a producer warp
streams the weight through a ring of ``S`` slots, each a stage of
``nblk / 128`` TMA boxes of ``[KC, 128]`` bytes, and four consumer warps run
``mma.sync`` on fragments built from the packed bytes.

* I :func:`int4_stream_matvec`: the body of ``nibble_matvec_acc`` (exact
  nibbles of the biased-lo bytes, bf16 mma, f32 sums); ``S`` and ``nblk``
  are the swept ring depth and tile width.
* J :func:`int4_unpack_matvec`: ``S = 2``, ``nblk = 512`` and one of four
  bodies: ``dma-floor`` (``y[w, r, c] = q4[w, r, c]`` for the lo half, zero
  hi half: the ring alone), ``current`` (signed-lo bytes, ``q4 ^ 8``),
  ``andtrick`` (I's body), ``w4a8`` (int8 ``x``, s8 mma, exact int32 sums).

A work item is (weight, column tile of ``nblk``, K slice of ``kslice``
rows); a ring slot holds ``KC`` weight rows.  :func:`plan` checks the
shapes (:func:`check_stages`), asks the card how many blocks an SM holds
and how much shared memory a block takes, and splits K (:func:`split_rows`)
until the work items (:func:`work_items`) fill the resident blocks.  The
TPU kernels leave the last weight's result in one ``[8, N]`` output; here
``y`` has all ``NW``, and the tools read ``y[NW - 1]``.  Each kernel has a plain PyTorch
version of the same arithmetic; the dispatchers launch the kernel on a CUDA
tensor and run the plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from dynam3d_torch.ops import kernels
from dynam3d_torch.ops.int4 import _ticket_buffer

ROWS = 8                       # activation rows (the tools' BP)
STREAM_VARIANTS = ((2, 512), (3, 512), (4, 512), (4, 256), (6, 256), (8, 128))  # (S, nblk)
UNPACK_BODIES = ("dma-floor", "current", "andtrick", "w4a8")
UNPACK_S, UNPACK_NBLK = 2, 512
KC = 64                        # weight rows of a ring slot (the tools' kc): the body's box
NBLKS = (128, 256, 512)        # stage widths the kernels take: nblk / 128 boxes a stage
MAX_SLOTS = 8                  # ring slots the kernels take
MAX_SLICE = 1024               # K rows of x a block stages (int4_mma.cuh kMaxSlice)
_BODY_IDS = {"andtrick": 0, "dma-floor": 1, "current": 2, "w4a8": 3}


def check_stages(S: int, nblk: int, dblk: int) -> None:
    """Raises unless the kernels take ``S`` slots of stages ``nblk`` wide and
    ``KC`` rows divide ``dblk`` (else a stage would straddle a scale
    group).  Whether the slots fit shared memory is the card's answer
    (:func:`plan`)."""
    kernels.require(nblk in NBLKS, f"int4_stream: nblk must be one of {NBLKS}")
    kernels.require(1 <= S <= MAX_SLOTS, f"int4_stream: S must be 1..{MAX_SLOTS}")
    kernels.require(dblk % KC == 0, f"int4_stream: dblk={dblk} is not a multiple of {KC}")


def split_rows(nw: int, d: int, n2: int, dblk: int, nblk: int, kc: int, slots: int) -> int:
    """kslice, the weight rows of one work item: ``dblk`` (at most
    ``MAX_SLICE``) halved while the (weight, column tile, K slice) work
    items do not fill the card's ``slots`` resident blocks (SMs x blocks per
    SM).  Each further split adds a round of workspace writes and reads to
    every item's ordered sum."""
    ks = dblk
    while ks > MAX_SLICE and ks % 2 == 0:
        ks //= 2
    while work_items(nw, d, n2, nblk, ks) < slots and ks % (2 * kc) == 0:
        ks //= 2
    return ks


def work_items(nw: int, d: int, n2: int, nblk: int, kslice: int) -> int:
    """Blocks of a launch: weights x column tiles x K slices."""
    return nw * (n2 // nblk) * (d // kslice)


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
    tail = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.int4_stream_matvec.argtypes = tail
    lib.int4_stream_matvec.restype = I
    lib.int4_unpack_matvec.argtypes = [I] + tail
    lib.int4_unpack_matvec.restype = I
    lib.int4_stream_smem.argtypes = [I, I]
    lib.int4_stream_smem.restype = I
    lib.int4_stream_blocks_per_sm.argtypes = [I, I, I, P]
    lib.int4_stream_blocks_per_sm.restype = I
    lib._d3_bound = True


class Plan(NamedTuple):
    """A launch's plan: K rows per work item, the work items, and the card's
    blocks per SM and dynamic shared memory per block at its (S, nblk)."""
    kslice: int
    items: int
    blocks_per_sm: int
    smem: int


# (device, body, S, nblk) -> (SMs, blocks per SM, shared memory of a block)
_card: Dict[Tuple[torch.device, str, int, int], Tuple[int, int, int]] = {}


def plan(q4: torch.Tensor, body: str, S: int, nblk: int, dblk: int) -> Plan:
    """The plan of ``body``'s kernel on ``q4``'s card: K is split until the
    work items fill SMs x the blocks an SM holds (the card's occupancy
    query, cached per device and kernel)."""
    check_stages(S, nblk, dblk)
    key = (q4.device, body, S, nblk)
    if key not in _card:
        with torch.cuda.device(q4.device):
            sms = torch.cuda.get_device_properties(q4.device).multi_processor_count
            _card[key] = (sms, blocks_per_sm(body, S, nblk), library().int4_stream_smem(S, nblk))
    sms, per_sm, smem = _card[key]
    kernels.require(per_sm >= 1, f"int4_stream: S={S} slots of {KC} x {nblk} bytes and the "
                                 f"x slice ({smem} B) do not fit a block's shared memory")
    nw, d, n2 = q4.shape
    kslice = split_rows(nw, d, n2, dblk, nblk, KC, sms * per_sm)
    return Plan(kslice, work_items(nw, d, n2, nblk, kslice), per_sm, smem)


def _launch(name, body, x, q4, s_lo, s_hi, S, nblk, dblk):
    kernels.require_cuda([x, q4, s_lo, s_hi], name)
    nw, d, n2 = q4.shape
    kslice = plan(q4, body, S, nblk, dblk).kslice
    nsplit = d // kslice
    y = torch.empty((nw, ROWS, 2 * n2), dtype=torch.float32, device=q4.device)
    ws = (torch.empty((nw, nsplit, ROWS, 2 * n2), dtype=torch.float32, device=q4.device)
          if nsplit > 1 and body != "dma-floor" else None)
    tickets = _ticket_buffer(q4.device, nw * (n2 // nblk))
    lib = library()
    args = (x.data_ptr(), q4.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, tickets.data_ptr(), nw, d, n2, dblk,
            nblk, S, kslice, kernels.stream_ptr(x))
    if name == "int4_stream_matvec":
        rc = lib.int4_stream_matvec(*args)
    else:
        rc = lib.int4_unpack_matvec(_BODY_IDS[body], *args)
    kernels.check(rc, name)
    kernels.count(kernels.launches, name)
    return y


def library():
    """The kernels' library (``csrc/int4_stream.cu``), built at first use."""
    lib = kernels.library("int4_stream")
    _bind(lib)
    return lib


def blocks_per_sm(body: str, S: int, nblk: int) -> int:
    """Blocks of ``body``'s kernel at ``(S, nblk)`` one SM of the current
    card holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0 where
    a block's shared memory exceeds what a block may take)."""
    count = ctypes.c_int(0)
    kernels.check(library().int4_stream_blocks_per_sm(_BODY_IDS[body], S, nblk,
                                                      ctypes.byref(count)),
                  "int4_stream_blocks_per_sm")
    return count.value


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
    kernels.require(nblk == UNPACK_NBLK, f"int4_unpack_matvec: the kernel takes nblk={UNPACK_NBLK}")
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
