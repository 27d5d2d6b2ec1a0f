"""The novel-view renders of a pretraining iteration (two views: the
banded k-NN with its near-mask read, neighbour conditioning, kernel C,
compositing), summed an iteration from the traced iterations'
``pretrain.render`` spans (``pretrain_spans.per_iter_ms``)."""

from perfbench.pretrain_spans import per_iter_ms


def read(d):
    return per_iter_ms(d, "pretrain.render")
