"""The episode driver's own time a B=1 step: each traced ``step`` span less
its children ``perceive``, ``generate`` and ``step.feed`` (the room's
render), averaged over the steps whose ``step`` span the window holds: the
prompt, the uploads, the read-back, parsing and the closing synchronize."""

from perfbench.program_spans import window

OTHERS = ("perceive", "generate", "step.feed")


def read(d):
    got = window(d)
    if got is None:
        return None
    own = {s.step: s.end - s.start for s in got[0] if s.name == "step"}
    for s in got[0]:
        if s.parent == "step" and s.name in OTHERS and s.step in own:
            own[s.step] -= s.end - s.start
    return 1e3 * sum(own.values()) / len(own) if own else None
