"""Byte tokenizer (bytes plus the chat specials) and the VLN prompt template, with the
episode's history rule (the newest decoded action text, cut at ``<|end|>``,
pushed onto four slots that start as ``"none\\n"``)."""

from __future__ import annotations

from typing import List, Sequence

SPECIALS = ["<|user|>", "<|end|>", "<|assistant|>", "<image>", "<pad>", "<s>"]


class ByteTokenizer:
    """UTF-8 bytes (ids 0..255) + special-token ids from 256."""

    def __init__(self, vocab_size: int = 32064):
        self.vocab_size = vocab_size
        self._special_to_id = {s: 256 + i for i, s in enumerate(SPECIALS)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.pad_id = self._special_to_id["<pad>"]
        self.bos_id = self._special_to_id["<s>"]
        self.end_id = self._special_to_id["<|end|>"]
        self.image_id = self._special_to_id["<image>"]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            for s, sid in self._special_to_id.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    break
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                buf.append(t)
                continue
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
            if t in self._id_to_special and t not in (self.pad_id, self.bos_id):
                out.append(self._id_to_special[t])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def build_prompt(instruction: str, history_actions: Sequence[str], n_mm_tokens: int,
                 gt_text: str = "") -> str:
    """The VLN prompt template."""
    return (
        "<|user|>\n"
        + "<image>" * n_mm_tokens
        + "\nInstruction:\n"
        + instruction
        + "\nHistory actions:\n"
        + "".join(history_actions)
        + "<|end|>\n<|assistant|>\nNext action:\n"
        + gt_text
    )


def histories(tok: ByteTokenizer, gens: Sequence[Sequence[int]], slots: int = 4) -> List[List[str]]:
    """The history slots before each step of an episode whose steps served
    ``gens`` (ids per step, in order): entry ``k`` is what step ``k`` saw."""
    hist = ["none\n"] * slots
    out = []
    for g in gens:
        out.append(list(hist))
        text = tok.decode(g)
        cut = text.find("<|end|>")
        if cut != -1:
            text = text[:cut]
        hist = hist[1:] + [text + "\n"]
    return out
