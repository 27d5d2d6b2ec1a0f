"""One decode pass of the unfused route at B=12 (``greedy_decode``: the
pass's launches and the loop's ``bool`` read of its stop flags: real time),
from the traced step's ``generate.pass`` spans and the ``decode.passes``
counter (``program_spans.decode_pass_ms``)."""

from perfbench.program_spans import decode_pass_ms as read  # noqa: F401
