"""The gradient of a pretraining iteration (``torch.autograd.grad`` with
the 16 recomputed folds and the renderer's backward, to the skip read
that waits for it: host time, the device catching up in
``pretrain.update``), from the traced iterations' ``pretrain.backward``
spans (``pretrain_spans.per_iter_ms``)."""

from perfbench.pretrain_spans import per_iter_ms


def read(d):
    return per_iter_ms(d, "pretrain.backward")
