"""Calls that wait for the card a B=1 step: the program's ``sync`` counter
over the traced window (one cycle of the step per traced step, episode
starts and ends included), over the traced steps."""

from perfbench.program_spans import window


def read(d):
    got = window(d)
    if got is None or "sync" not in got[1]:
        return None
    return got[1]["sync"] / len(d["trace_steps"])
