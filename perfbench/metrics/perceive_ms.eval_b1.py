"""Perception's time a B=1 step (``policy.perceive`` and the ``mm_finite``
read that closes it: real time), from the program's spans in the traced
steps (``program_spans.perceive_ms``)."""

from perfbench.program_spans import perceive_ms as read  # noqa: F401
