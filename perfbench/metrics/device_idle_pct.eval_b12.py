"""The device's idle share of the traced window (``readers.idle_pct``)."""

from perfbench.readers import idle_pct as read  # noqa: F401
