"""The episode store: fixed-stride step records in one file, read through
``np.memmap``; the port's own copy of the store in ``native/`` (there a
C++ reader with a page-prefetch thread).

Layout, little-endian: four int64 (``MAGIC``, step count, step bytes, meta
bytes), the meta as UTF-8 JSON, then the steps back to back.  The step
layout is the caller's (``runtime/dagger.py`` defines one); the store
treats a step as bytes.  A file written here is read by the reference's
reader and the other way round.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np

MAGIC = 0xD14A3D
_HEADER = np.dtype("<i8")


def write_episode_store(path: str, steps: Sequence[bytes], meta: Dict) -> None:
    """Write ``steps`` (equal-size byte strings, one a step) under ``meta``."""
    step_bytes = len(steps[0]) if steps else 0
    if any(len(s) != step_bytes for s in steps):
        raise ValueError("episode store steps must all have the same size")
    meta_b = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(np.asarray([MAGIC, len(steps), step_bytes, len(meta_b)], _HEADER).tobytes())
        f.write(meta_b)
        for s in steps:
            f.write(s)


class EpisodeStore:
    """A store file mapped read-only: ``n_steps``, ``step_bytes``, ``meta``
    and ``read(t)``.  ``prefetch_ahead`` is accepted for the reference
    reader's signature and does nothing: its prefetch thread touches the
    pages of the next steps, and here the kernel's read-ahead of the
    mapping does that work."""

    def __init__(self, path: str, prefetch_ahead: int = 4):
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(4 * _HEADER.itemsize), _HEADER)
            if hdr.size != 4 or int(hdr[0]) != MAGIC:
                raise IOError(f"cannot open episode store: {path}")
            self.n_steps, self.step_bytes, meta_bytes = (int(v) for v in hdr[1:])
            self.meta = json.loads(f.read(meta_bytes).decode())
        self.prefetch_ahead = prefetch_ahead
        offset = 4 * _HEADER.itemsize + meta_bytes
        self._steps = (np.memmap(path, np.uint8, "r", offset,
                                 (self.n_steps, self.step_bytes))
                       if self.n_steps and self.step_bytes else None)

    def read(self, t: int) -> bytes:
        if not 0 <= t < self.n_steps:
            raise IndexError(f"step {t} of a store of {self.n_steps}")
        return self._steps[t].tobytes()

    def close(self) -> None:
        """Drop the mapping (``read`` hands out copies, so nothing holds it)."""
        self._steps = None
