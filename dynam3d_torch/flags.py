"""Feature gates of the serving slice, read once at import time.

The same environment names as the reference package's gates; set them in
the environment before importing ``dynam3d_torch``.  Tests that flip a gate
monkeypatch the constant.
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
