"""Copy-paste self-check: flag any source file of a repository more than
``--threshold`` similar (``difflib`` ratio over its stripped non-blank
lines) to a reference source of the same name or of a similar size.

    python -m dynam3d_torch.tools.copycheck --reference DIR [--repo DIR]
        [--threshold 0.6] [--json]

Port of ``tools/copycheck.py`` with its report: ``{"checked", "threshold",
"flagged": [{"file", "reference", "similarity"}]}``.  Files under 30 lines
are not checked; ``.git``, ``__pycache__``, ``runs``, ``.claude`` and
``tests`` are skipped.  The two roots are arguments (``--repo`` defaults
to this checkout).  Exit code 1 when anything is flagged.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF = None
SKIP_DIRS = {".git", "__pycache__", "runs", ".claude", "tests"}


def _sources(root, exts=(".py", ".cpp", ".cc", ".h")):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for fn in filenames:
            if fn.endswith(exts):
                yield os.path.join(dirpath, fn)


def _lines(path):
    try:
        with open(path, errors="replace") as f:
            return [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []


def report(repo: str, ref: str, threshold: float = 0.6) -> dict:
    ref_lines = {f: _lines(f) for f in _sources(ref)}
    by_name = {}
    for f in ref_lines:
        by_name.setdefault(os.path.basename(f).lower(), []).append(f)
    flagged, checked = [], 0
    for mine in _sources(repo):
        ml = _lines(mine)
        if len(ml) < 30:
            continue
        checked += 1
        # a reference file of the same name, or of a size within 40%
        cands = set(by_name.get(os.path.basename(mine).lower(), []))
        cands.update(rf for rf, rl in ref_lines.items()
                     if rl and 0.6 <= len(rl) / max(len(ml), 1) <= 1.67)
        best, best_r = None, 0.0
        for rf in cands:
            rl = ref_lines[rf]
            if not rl:
                continue
            r = difflib.SequenceMatcher(None, ml, rl, autojunk=False).ratio()
            if r > best_r:
                best, best_r = rf, r
        if best_r > threshold:
            flagged.append({"file": os.path.relpath(mine, repo),
                            "reference": os.path.relpath(best, ref),
                            "similarity": round(best_r, 3)})
    return {"checked": checked, "threshold": threshold, "flagged": flagged}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=REPO)
    p.add_argument("--reference", default=REF, required=REF is None)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    out = report(args.repo, args.reference, args.threshold)
    print(json.dumps(out) if args.json else json.dumps(out, indent=2))
    return 1 if out["flagged"] else 0


if __name__ == "__main__":
    sys.exit(main())
