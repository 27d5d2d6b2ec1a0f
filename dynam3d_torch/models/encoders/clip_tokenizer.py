"""CLIP text tokenization; port of ``models/encoders/clip_tokenizer.py``.

:func:`hash_tokenize` needs no vocabulary file: each lower-cased word maps
to a stable id below BOS by the first four bytes of its MD5.
:class:`HFClipTokenizer` gives the exact BPE ids from a local copy of an
HF ``CLIPTokenizer``.  Both return ``[B, 77]`` int32 framed by BOS = 49406
and EOT = 49407, EOT being the largest id (``encode_text`` reads the
feature at the argmax).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

BOS = 49406
EOT = 49407
CONTEXT = 77


def hash_tokenize(texts: Sequence[str], context: int = CONTEXT) -> np.ndarray:
    out = np.zeros((len(texts), context), np.int32)
    for b, text in enumerate(texts):
        ids: List[int] = [BOS]
        for word in text.lower().strip().split():
            h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
            ids.append(1 + h % (BOS - 1))
            if len(ids) >= context - 1:
                break
        ids.append(EOT)
        out[b, : len(ids)] = ids
    return out


class HFClipTokenizer:
    """An HF ``CLIPTokenizer`` loaded from ``path`` only (never fetched)."""

    def __init__(self, path: str):
        from transformers import CLIPTokenizer

        self.tok = CLIPTokenizer.from_pretrained(path, local_files_only=True)

    def __call__(self, texts: Sequence[str], context: int = CONTEXT) -> np.ndarray:
        enc = self.tok(list(texts), padding="max_length", max_length=context, truncation=True,
                       return_tensors="np")
        return enc["input_ids"].astype(np.int32)
