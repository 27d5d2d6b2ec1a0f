"""The forward fold of a pretraining iteration's 16 views into the memory
(``pretrain_step_loss``'s loop, the reads inside it included; the
backward's recompute is not in it), from the traced iterations'
``pretrain.fold`` spans (``pretrain_spans.per_iter_ms``)."""

from perfbench.pretrain_spans import per_iter_ms


def read(d):
    return per_iter_ms(d, "pretrain.fold")
