"""Feature gates of the port, under the reference package's environment names.

The serving gates are read once at import time: set them in the environment
before importing ``dynam3d_torch``; tests that flip one monkeypatch the
constant.  The renderer's k-NN gates are functions read at call time, so a
driver can switch the stage-1 k-NN between calls in one process.
"""

from __future__ import annotations

import os


def _on(name: str, default: str = "") -> bool:
    return os.environ.get(name, default) not in ("", "0", "false")


#: Speculative greedy decode with n-gram prompt-lookup drafts at B=1.
SPEC_DECODE: bool = _on("DYNAM3D_SPEC_DECODE", "1")

#: Draft window K (tokens verified per pass, including the carried token).
SPEC_DRAFT_LEN: int = int(os.environ.get("DYNAM3D_SPEC_K", "8"))

#: W8A8 prefill: per-token int8 activations against the int8 weights.
W8A8_PREFILL: bool = _on("DYNAM3D_W8A8_PREFILL", "1")


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
