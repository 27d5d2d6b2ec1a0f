"""The whole step's share of the bf16 peak over the traced window
(``readers.vln_step_mfu``)."""

from perfbench.readers import vln_step_mfu as read  # noqa: F401
