"""The batch of a pretraining iteration (``PretrainRunner.build_batch``:
the uploads, CLIP over the 16 frames, the patch geometry and segments, to
the synchronize after it: real time), from the traced iterations'
``pretrain.build`` spans (``pretrain_spans.per_iter_ms``)."""

from perfbench.pretrain_spans import per_iter_ms


def read(d):
    return per_iter_ms(d, "pretrain.build")
