"""The int4 kernels of the unfused decode route at B=12 (A for qkv, o and
the head; F for the MLP; ``ops/int4.py``) against their bytes bound in the
traced steps.  Passes are F's launches over the layers
(``ops.kernels.launches``); each pass reads every layer's packed weights
and scales and the head's once, and A's other launches are the prefills'
heads.  Over the device time of ``int4_matvec_kernel`` and
``int4_mlp_kernel``."""

from perfbench import flops
from perfbench.trace import kernel_seconds


def read(d):
    t, n = d["trace"], d["trace_launches"]
    if not t or not n.get("int4_mlp"):
        return None
    p3 = d["phi3"]
    lb = flops.phi3_int4_layer_bytes(p3)
    head = flops.lm_head_bytes(p3)
    passes = n["int4_mlp"] / p3.num_layers
    heads = max(n.get("int4_matvec", 0) - passes * (2 * p3.num_layers + 1), 0)
    total = passes * (p3.num_layers * sum(lb.values()) + head) + heads * head
    sec = kernel_seconds(t, "int4_matvec_kernel", "int4_mlp_kernel")
    return 100.0 * total / flops.HBM_BPS / sec if sec > 0 else None
