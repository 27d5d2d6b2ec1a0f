"""Calls that wait for the card in a pretraining iteration: the program's
``sync`` counter over the traced window (the fold's and its recompute's
reads, the banded k-NN's near-mask reads, the skip read, the metrics'
reads, the iteration's synchronizes) over the ``pretrain.iters`` it
counted (``pretrain_spans.syncs_per_iter``)."""

from perfbench.pretrain_spans import syncs_per_iter as read  # noqa: F401
