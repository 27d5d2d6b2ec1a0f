"""Tokenizers and the VLN prompt template; own copy of
``models/vlm/tokenizer.py`` (``ByteTokenizer``, ``HFTokenizer``,
``build_prompt``)."""

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


class HFTokenizer:
    """A tokenizer saved on disk (``AutoTokenizer``, local files only).
    ``transformers`` is imported here, not with the module."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self.tok)
        self.pad_id = self.tok.pad_token_id or 32000
        self.bos_id = self.tok.bos_token_id
        self.end_id = self.tok.convert_tokens_to_ids("<|end|>")
        self.image_id = self.tok.convert_tokens_to_ids("<image>")

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self.tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=False)


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
