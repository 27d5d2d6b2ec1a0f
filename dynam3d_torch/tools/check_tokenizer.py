"""Assert every tokenizer convention the runtime relies on, given a REAL
llava-phi-3 tokenizer directory; port of ``tools/check_tokenizer.py`` on
the port's ``HFTokenizer`` and ``build_prompt``.

The build's prompt pipeline (models/vlm/tokenizer.py + runtime/episode.py)
bakes in conventions of the ``xtuner/llava-phi-3-mini-hf`` processor
(Policy_Dynam3D_VLN.py:373,393) that are currently pinned only against the
self-built ByteTokenizer.  With the sentencepiece assets at hand, run

    python -m dynam3d_torch.tools.check_tokenizer --path /path/to/llava-phi-3-mini-hf

and every convention below is verified against the real model.  Exit code 0
= all conventions hold; the JSON report lists each check for PARITY.md.

Checks:
  C1  <image> encodes to exactly ONE id per occurrence (no sub-word split)
  C2  the <image> id equals Phi3Config.image_token_id (32038)
  C3  pad id is <|endoftext|> (32000) and <|end|> is a single token (32007)
  C4  splice offset: the first <image> position in the encoded prompt is
      INDEPENDENT of instruction/history content (EpisodeRunner derives it
      from a probe once and reuses it for every episode)
  C5  an n-token <image> block stays a contiguous n-id span (the runtime
      scatters multimodal embeddings over [splice, splice+n))
  C6  no whitespace absorption: the "\\n" between the image block and
      "Instruction:" survives encode->decode (added-token lstrip/rstrip
      flags can silently eat it, shifting every position after the splice)
  C7  action-text decode round-trip: the quantized action grammar
      ("turn left N steps, move forward M steps." / "stop." / "error.")
      survives encode->decode, so parse_action sees the text the model
      emitted (Policy_Dynam3D_VLN.py:472-506)
  C8  vocab bound: every id the prompt produces < Phi3Config.vocab_size
"""

from __future__ import annotations

import argparse
import json
import sys


def run_checks(path: str) -> dict:
    from dynam3d_torch.config import Phi3Config
    from dynam3d_torch.models.vlm.tokenizer import HFTokenizer, build_prompt

    cfg = Phi3Config()
    tok = HFTokenizer(path)
    checks = {}

    def check(name, ok, detail=""):
        checks[name] = {"ok": bool(ok), "detail": str(detail)}

    # C1: single-token <image>
    one = tok.encode("<image>", add_bos=False)
    three = tok.encode("<image><image><image>", add_bos=False)
    check("C1_single_token_image", len(one) == 1 and len(three) == 3,
          f"encode('<image>')={one}")

    # C2: image id arithmetic
    check("C2_image_id", tok.image_id == cfg.image_token_id,
          f"{tok.image_id} vs config {cfg.image_token_id}")

    # C3: pad/end ids
    end_one = tok.encode("<|end|>", add_bos=False)
    check("C3_pad_end_ids",
          tok.pad_id == cfg.pad_token_id and tok.end_id == cfg.end_token_id
          and end_one == [tok.end_id],
          f"pad={tok.pad_id} end={tok.end_id} enc={end_one}")

    # C4: splice offset is content-independent
    probes = [
        tok.encode(build_prompt("x", ["none\n"] * 4, 1)),
        tok.encode(build_prompt("Walk to the kitchen and stop.",
                                ["move forward 2 steps.\n"] * 4, 1)),
        tok.encode(build_prompt("Turn around.", ["stop.\n"] * 4, 1)),
    ]
    offs = [p.index(tok.image_id) for p in probes]
    check("C4_static_splice_offset", len(set(offs)) == 1, f"offsets={offs}")

    # C5: contiguous n-id span
    n = 37
    ids = tok.encode(build_prompt("x", ["none\n"] * 4, n))
    pos = [i for i, t in enumerate(ids) if t == tok.image_id]
    contig = len(pos) == n and pos == list(range(pos[0], pos[0] + n))
    check("C5_contiguous_span", contig, f"count={len(pos)}")

    # C6: whitespace survives around the image block
    dec = tok.decode(ids)
    check("C6_no_whitespace_absorption", "\nInstruction:" in dec,
          dec[:120].replace("\n", "\\n"))

    # C7: action-text round-trip
    ok7, det7 = True, []
    for text in ("turn left 2 steps, move forward 4 steps.",
                 "turn right 4 steps, move forward 1 steps.",
                 "move forward 3 steps.", "stop.", "error."):
        rt = tok.decode(tok.encode(text, add_bos=False))
        if text not in rt:
            ok7 = False
            det7.append(f"{text!r}->{rt!r}")
    check("C7_action_text_roundtrip", ok7, "; ".join(det7))

    # C8: vocab bound
    check("C8_vocab_bound", max(ids) < cfg.vocab_size,
          f"max_id={max(ids)} vocab={cfg.vocab_size}")

    checks["all_ok"] = all(
        v["ok"] for k, v in checks.items() if isinstance(v, dict)
    )
    return checks


def build_fixture(path: str) -> str:
    """A llava-phi-3-LIKE byte-level tokenizer saved to ``path``: same
    structural conventions (bos post-processor, rstrip'ing chat specials,
    plain <image>), different ids — the --self-test asset."""
    from tokenizers import AddedToken, Regex, Tokenizer, pre_tokenizers
    from tokenizers.models import WordLevel
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for ch in sorted(pre_tokenizers.ByteLevel.alphabet()):
        vocab[ch] = len(vocab)
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
        pre_tokenizers.Split(Regex("[\\s\\S]"), "isolated"),
    ])
    tok.decoder = ByteLevelDecoder()
    tok.post_processor = TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)]
    )
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>", pad_token="<pad>",
    )
    fast.add_special_tokens({
        "additional_special_tokens": [
            AddedToken("<|user|>", rstrip=True, special=True),
            AddedToken("<|end|>", rstrip=True, special=True),
            AddedToken("<|assistant|>", rstrip=True, special=True),
            AddedToken("<image>", special=True),
        ]
    })
    fast.save_pretrained(path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", default=None,
                   help="local HF tokenizer dir (llava-phi-3-mini-hf)")
    p.add_argument("--self-test", action="store_true",
                   help="run the checker against the built-in llava-phi-3-"
                        "like fixture: the structural checks (C1, C4-C8) "
                        "must pass and the id-arithmetic checks (C2/C3) "
                        "must correctly flag that it is NOT the real asset")
    p.add_argument("--json", action="store_true",
                   help="single-line JSON output")
    args = p.parse_args(argv)
    if not args.path and not args.self_test:
        p.error("--path or --self-test required")

    if args.self_test:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            checks = run_checks(build_fixture(td))
        structural = ("C1_single_token_image", "C4_static_splice_offset",
                      "C5_contiguous_span", "C6_no_whitespace_absorption",
                      "C7_action_text_roundtrip", "C8_vocab_bound")
        ok = all(checks[k]["ok"] for k in structural) and not (
            checks["C2_image_id"]["ok"] or checks["all_ok"]
        )
        out = {"self_test_ok": ok, "checks": checks}
        print(json.dumps(out) if args.json else json.dumps(out, indent=2))
        return 0 if ok else 1

    checks = run_checks(args.path)
    print(json.dumps(checks) if args.json else json.dumps(checks, indent=2))
    return 0 if checks["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
