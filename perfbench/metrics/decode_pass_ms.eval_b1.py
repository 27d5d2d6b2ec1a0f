"""One decode or verify pass of the B=1 ring (``greedy_decode_spec``: the
host's n-gram draft, the pass's launches and its argmax read: real time),
from the traced steps' ``generate.pass`` spans and the ``decode.passes``
counter (``program_spans.decode_pass_ms``)."""

from perfbench.program_spans import decode_pass_ms as read  # noqa: F401
