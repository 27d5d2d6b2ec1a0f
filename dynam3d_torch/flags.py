"""Feature gates of the port, under the reference package's environment names.

``SPEC_DRAFT_LEN`` and ``W8A8_PREFILL`` are read once at import time.  The
decode-route gates and the renderer's k-NN gates are functions read at call
time, so a caller (``chip_smoke.py``, a test) can switch routes between calls
in one process.  This is a deliberate difference from the reference package,
which resolves every gate at import because its gates select among compiled
programs; the port runs eagerly and has nothing to recompile.

Two reference gates are not ported: ``DYNAM3D_DISABLE_PALLAS`` (on the card
it would put the kernels' plain versions on the main path) and
``DYNAM3D_FUSED_RING_SLOTS`` (the TPU kernel's DMA ring depth, which has no
counterpart in the Hopper kernels).
"""

from __future__ import annotations

import os


def _on(name: str, default: str = "") -> bool:
    return os.environ.get(name, default) not in ("", "0", "false")


#: Draft window K (tokens verified per pass, including the carried token).
SPEC_DRAFT_LEN: int = int(os.environ.get("DYNAM3D_SPEC_K", "8"))

#: W8A8 prefill: per-token int8 activations against the int8 weights.
W8A8_PREFILL: bool = _on("DYNAM3D_W8A8_PREFILL", "1")


def spec_decode() -> bool:
    """Speculative greedy decode with n-gram prompt-lookup drafts: B=1
    through ``greedy_decode_spec``, B=2..4 through the grouped
    ``greedy_decode_spec_batched``."""
    return _on("DYNAM3D_SPEC_DECODE", "1")


def fused_attn() -> bool:
    """Int4 decode through the fused decode-layer kernels (the ring, or the
    split attention + MLP-block pair at B=1); off runs the unfused
    ``decode_forward``."""
    return _on("DYNAM3D_FUSED_ATTN", "1")


def fused_ring() -> bool:
    """The whole-layer ring (kernels A and B) for B <= 8 rows; off leaves
    B=1 on the split route and larger batches unfused."""
    return _on("DYNAM3D_FUSED_RING", "1")


def int4_fused_mlp() -> bool:
    """The unfused route's int4 MLP as one fused kernel (gate_up, SwiGLU,
    down); off runs it as two int4 matmuls with bf16 SwiGLU between."""
    return _on("DYNAM3D_INT4_FUSED_MLP", "1")


def int4_grid2d() -> bool:
    """``int4_matmul`` through the 2-D-grid matvec (one block per column tile
    and scale group) instead of kernel A."""
    return _on("DYNAM3D_INT4_GRID2D")


def disable_banded_knn() -> bool:
    """Render stage 1 takes the flat k-NN (``knn_auto``) instead of the
    depth-band x tile-box culled scan."""
    return _on("DYNAM3D_DISABLE_BANDED_KNN")


def disable_morton_knn() -> bool:
    """The banded scan reads the patch table in slot order, without the
    Morton pre-sort that tightens its tile boxes."""
    return _on("DYNAM3D_DISABLE_MORTON_KNN")


def enable_pallas_knn() -> bool:
    """``knn_auto`` launches the k-NN kernel (kernel D) on CUDA tensors of
    at least 1024 points; the flat tiled scan otherwise."""
    return _on("DYNAM3D_ENABLE_PALLAS_KNN")
