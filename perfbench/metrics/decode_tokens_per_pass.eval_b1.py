"""Tokens a decode pass yields at B=1 (speculation's acceptance): the
window's sum of ``EpisodeRunner.step_log`` ``tokens`` over its ``passes``."""


def read(d):
    steps = [s for s in d["steps"] if s.get("passes")]
    passes = sum(s["passes"] for s in steps)
    return sum(s["tokens"] for s in steps) / passes if passes else None
