"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/dynam3d_torch/`` beside the
package (the file name carries a hash of the source and of the shared
``csrc/*.cuh`` headers, so an edited source is rebuilt) and loaded with
``ctypes``.  :func:`build_all` compiles every
source at once, one ``nvcc`` process each.

``launches`` counts, per kernel, the launches made through its wrapper (one
source may hold several kernels: ``int4_mlp.cu`` holds ``int4_mlp`` and
``int4_mlp_block``, ``int4_stream.cu`` ``int4_stream_matvec`` and
``int4_unpack_matvec``);
``plain_calls`` counts calls of the plain PyTorch versions on CUDA tensors.
A launch replayed from a CUDA graph is counted at its replay, not at its
capture (``models/vlm/phi3.py``).
A run resets both with :func:`reset_counts` and reads them afterwards to
show which path it went through.  :func:`ptxas_summary` reads the
registers and spills ``ptxas -v`` reported for each kernel of a source
built in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

SOURCES = ("int4_matvec", "decode_attn", "nerf_mlp", "knn_topk", "int4_matvec2d",
           "int4_mlp", "decode_attn_layer", "int4_stream")
KERNELS = SOURCES[:6] + ("int4_mlp_block", "decode_attn_layer", "int4_stream_matvec",
                         "int4_unpack_matvec")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "dynam3d_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
]

launches: Dict[str, int] = {name: 0 for name in KERNELS}
plain_calls: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}
_lock = threading.Lock()


_count_lock = threading.Lock()


def count(counter: Dict[str, int], name: str, n: int = 1) -> None:
    """Add ``n`` to ``counter[name]`` (``launches`` or ``plain_calls``);
    under a lock, since ``EpisodeRunner.run_interleaved`` launches from
    threads."""
    with _count_lock:
        counter[name] += n


def reset_counts() -> None:
    with _count_lock:
        for d in (launches, plain_calls):
            for k in d:
                d[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, target) or None
    when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish_build(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    _build_logs[name] = out
    os.replace(tmp, target)


def build_all() -> None:
    """Compile every kernel source in parallel (no-op for built ones)."""
    with _lock:
        started = [(n, _start_build(n)) for n in SOURCES]
        for n, s in started:
            if s is not None:
                _finish_build(n, s)


def _kernel_name(sym: str) -> str:
    """The unqualified name of a mangled ``*_kernel`` symbol: the last of
    the length-prefixed names after ``_Z`` / ``_ZN`` (``_ZN5d3mma18int4_
    matvec_kernelILi1EE...`` -> ``int4_matvec_kernel``); the symbol itself
    when it is not of that form."""
    i = 3 if sym.startswith("_ZN") else 2 if sym.startswith("_Z") else len(sym)
    last = sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        n = int(sym[i:j])
        last, i = sym[j:j + n], j + n
    return last if last.endswith("_kernel") else sym


def ptxas_summary(name: str) -> List[Tuple[str, int, int, int]]:
    """``(kernel, registers, spill store bytes, spill load bytes)`` for each
    entry function of ``csrc/<name>.cu`` from its ``ptxas -v`` report;
    empty when the library was not built by this process.  The kernel is
    named by its symbol's readable part and template arguments, e.g.
    ``int4_matvec_mma_kernel<2>``."""
    out, fn = [], None
    spills = (0, 0)
    for line in _build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            args = re.findall(r"Li(\d+)E", sym)
            fn = _kernel_name(sym) + (f"<{','.join(args)}>" if args else "")
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spills))
            fn = None
    return out


def build_warnings(name: str) -> List[str]:
    """The warnings and performance notes of ``csrc/<name>.cu``'s build in
    this process (ptxas reports there, for one, wgmma it had to
    serialize)."""
    return [ln.strip() for ln in _build_logs.get(name, "").splitlines()
            if "warning" in ln.lower() or "performance" in ln.lower()]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            s = _start_build(name)
            if s is not None:
                _finish_build(name, s)
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(tensors: List[torch.Tensor], name: str) -> None:
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev,
                f"{name}: every tensor must be on the same CUDA device")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")
