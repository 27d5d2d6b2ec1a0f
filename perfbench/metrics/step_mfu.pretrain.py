"""The pretraining step's share of the bf16 peak over the traced window:
each traced iteration's model FLOPs (``flops_fields.step_flops``: the
CLIP encode, the fold's encoders forward and backward, the renderer
forward and backward, no recompute) over the window's seconds."""

from perfbench import flops


def read(d):
    t = d["trace"]
    if not t or not t.get("window_s") or not d.get("flops_per_iter"):
        return None
    return 100.0 * sum(d["flops_per_iter"]) / t["window_s"] / flops.BF16_PEAK
