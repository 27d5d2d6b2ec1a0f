"""Training scalars; port of ``runtime/logging.py`` (``MetricsLogger``).

Every scalar is one line of an append-only ``scalars.jsonl`` (``tag``,
``value``, ``step``, wall-clock ``t``); when a TensorBoard writer can be
imported, the same scalars go to it too.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, flush_every: int = 20):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a")
        self._n = 0
        self.flush_every = flush_every
        self._tb = None
        try:  # optional TensorBoard mirror
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "t": time.time()}) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        self._f.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
