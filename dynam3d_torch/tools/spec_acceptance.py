"""Speculative-decode acceptance on the action grammar's text: how many
tokens a verify pass would emit when the model's greedy argmax is the
known continuation (a trained policy's regime), under the exact accept
rule of ``phi3.greedy_decode_spec`` and its real drafting function
(``phi3._ngram_draft``), over prompt token streams of the runtime's
``ByteTokenizer`` and ``build_prompt``.

    python -m dynam3d_torch.tools.spec_acceptance [--draft-len 8] [--json]
        [--granularity char|word|both]

Port of ``tools/spec_acceptance.py``, with its scenarios, instructions,
report and verdict: host work only, so it runs anywhere and needs no card.
A verify pass streams the same int4 weights as one plain token plus ~10%
for the draft rows (the reference's break-even, 1.10 tokens a pass);
``--granularity word`` runs the scenarios through a word + punctuation
proxy tokenizer (about one token a word, the stream length of a
sentencepiece tokenizer on this grammar), and the default reports both and
takes its verdict from the worse.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np

BREAK_EVEN = 1.10


# Representative R2R val-unseen-style instructions (the register the model
# is prompted with: multi-clause indoor routes, ss_trainer_Dynam3D.py:615).
INSTRUCTIONS = [
    "Walk past the couch and table. Turn left and walk down the hallway. "
    "Stop in the doorway of the bathroom.",
    "Exit the bedroom and turn right. Walk straight past the kitchen "
    "island and wait near the refrigerator.",
    "Go down the stairs and turn left at the bottom. Walk through the "
    "living room and stop next to the piano.",
    "Head toward the dining table, then turn around and walk out onto "
    "the balcony. Stop once you are outside.",
]

# Action-text scenarios: (history entries, continuation the trained model
# would emit).  The grammar is the quantized 15-degree / 0.25 m text of
# Policy_Dynam3D_VLN.py:472-506.
SCENARIOS = [
    # the common regime: the agent continues a motion it just made -> the
    # continuation appears verbatim in the history
    ("repeat", ["turn left 2 steps, move forward 4 steps.\n"] * 2
     + ["move forward 4 steps.\n"] * 2,
     "turn left 2 steps, move forward 4 steps."),
    # novel counts but shared grammar: only the phrase skeleton hits
    ("novel-counts", ["turn right 1 steps, move forward 2 steps.\n",
                      "move forward 4 steps.\n",
                      "turn left 3 steps, move forward 1 steps.\n",
                      "move forward 2 steps.\n"],
     "turn right 2 steps, move forward 3 steps."),
    # first step of an episode: empty history ("none"), everything must
    # come from the instruction text
    ("cold-start", ["none\n"] * 4,
     "move forward 4 steps."),
    # terminal step
    ("stop", ["move forward 2 steps.\n", "move forward 1 steps.\n",
              "turn left 1 steps, move forward 2 steps.\n",
              "move forward 1 steps.\n"],
     "stop."),
]


def simulate(prompt_ids, continuation_ids, k: int):
    """``(tokens, passes)``: greedy_decode_spec's accept rule pass by pass
    with the real ``_ngram_draft``, the model's argmax being the
    continuation."""
    from dynam3d_torch.models.vlm.phi3 import _ngram_draft

    S, N = len(prompt_ids), len(continuation_ids)
    hist = np.full((S + N + k + 2,), -1, np.int64)
    hist[:S] = prompt_ids
    hist[S] = continuation_ids[0]          # the prefill's argmax
    n_em, passes = 1, 0
    while n_em < N:
        last = continuation_ids[n_em - 1]
        prev = continuation_ids[n_em - 2] if n_em >= 2 else -1
        prev2 = continuation_ids[n_em - 3] if n_em >= 3 else -1
        b3 = S + n_em - 4                  # prev3 from hist, as the decode loop reads it
        prev3 = int(hist[b3]) if b3 >= 0 else -1
        drf = _ngram_draft(hist, S + n_em, prev3, prev2, prev, last, k)
        acc = 1
        for j in range(k - 1):
            if n_em + j >= N or drf[j] != continuation_ids[n_em + j]:
                break
            acc += 1
        for j in range(acc):
            if n_em + j < N:
                hist[S + n_em + j] = continuation_ids[n_em + j]
        n_em += acc
        passes += 1
    return N, passes


class WordProxyTokenizer:
    """Whitespace words and punctuation marks as atomic ids, special
    strings (``<image>``, ``<|end|>`` ...) kept whole: about one token a
    word, as a sentencepiece tokenizer gives on this grammar (the drafting
    reads only id equality, not the vocabulary)."""

    _PAT = re.compile(r"<\|?[a-zA-Z_]+\|?>|\w+|[^\w\s]")

    def __init__(self):
        self._v = {}
        self.image_id = self._id("<image>")

    def _id(self, w):
        if w not in self._v:
            self._v[w] = len(self._v) + 10
        return self._v[w]

    def encode(self, text, add_bos=True):
        ids = [self._id(w) for w in self._PAT.findall(text)]
        return ([1] + ids) if add_bos else ids


def run_granularity(tok, k: int):
    """Tokens a pass per scenario (mean, min, max over the instructions)."""
    from dynam3d_torch.models.vlm.tokenizer import build_prompt

    n_mm = 576 + 37  # one view's patch grid + typical instance / zone tokens
    rows = []
    for name, history, cont in SCENARIOS:
        tp_all = []
        for ins in INSTRUCTIONS:
            ids = tok.encode(build_prompt(ins, history, n_mm))
            # the lookup stream: prompt ids, <image> slots never matching
            prompt = np.asarray([t if t != tok.image_id else -1 for t in ids], np.int64)
            N, passes = simulate(prompt, tok.encode(cont + "<|end|>", add_bos=False), k)
            tp_all.append(N / passes)
        rows.append({"scenario": name,
                     "tokens_per_pass": round(float(np.mean(tp_all)), 2),
                     "min": round(float(np.min(tp_all)), 2),
                     "max": round(float(np.max(tp_all)), 2)})
    mean_tpp = float(np.mean([r["tokens_per_pass"] for r in rows]))
    return {"scenarios": rows, "mean_tokens_per_pass": round(mean_tpp, 2),
            "verdict": "spec" if mean_tpp > BREAK_EVEN else "greedy"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--draft-len", type=int, default=None)
    p.add_argument("--json", action="store_true")
    p.add_argument("--granularity", choices=["char", "word", "both"], default="both")
    args = p.parse_args(argv)

    from dynam3d_torch import flags
    from dynam3d_torch.config import Phi3Config
    from dynam3d_torch.models.vlm.tokenizer import ByteTokenizer

    k = args.draft_len or max(2, min(int(flags.SPEC_DRAFT_LEN), 8))
    gran = {}
    if args.granularity in ("char", "both"):
        gran["char"] = run_granularity(ByteTokenizer(Phi3Config().vocab_size), k)
    if args.granularity in ("word", "both"):
        gran["word"] = run_granularity(WordProxyTokenizer(), k)
    worst = min(g["mean_tokens_per_pass"] for g in gran.values())
    out = {"draft_len": k, "break_even_tokens_per_pass": BREAK_EVEN, "granularity": gran,
           "worst_case_tokens_per_pass": round(worst, 2),
           "verdict": "spec" if worst > BREAK_EVEN else "greedy"}
    print(json.dumps(out) if args.json else json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
