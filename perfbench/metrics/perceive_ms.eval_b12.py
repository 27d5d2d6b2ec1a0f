"""Perception's time a B=12 step (``policy.perceive`` over the 12 rows and
the ``mm_finite`` read that closes it: real time), from the program's spans
in the traced step (``program_spans.perceive_ms``)."""

from perfbench.program_spans import perceive_ms as read  # noqa: F401
