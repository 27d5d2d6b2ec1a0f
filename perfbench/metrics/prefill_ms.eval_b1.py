"""The W8A8 prefill's time a B=1 step: the mean ``generate.prefill`` span
of the traced steps (``greedy_decode_spec``, from the prefill's launch to
the read of its token and the prompt's two reads after it: real time)."""

from perfbench.program_spans import mean_ms


def read(d):
    return mean_ms(d, "generate.prefill")
