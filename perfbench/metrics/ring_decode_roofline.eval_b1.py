"""Kernels A and B on the B=1 ring (``ops/decode.py::decode_layer_ring``)
against their bytes bound, in the traced steps: each pass reads every
layer's packed int4 weights and scales, the head's, and the live cache
(K and V of at least the prompt's valid positions) once; each step's
prefill reads the head once more.  Over the device time of
``int4_matvec_kernel`` and ``decode_attn_kernel``."""

from perfbench import flops
from perfbench.trace import kernel_seconds


def read(d):
    t = d["trace"]
    if not t or not d["trace_rows"]:
        return None
    p3 = d["phi3"]
    layer = sum(flops.phi3_int4_layer_bytes(p3).values())
    head = flops.lm_head_bytes(p3)
    total = 0
    for k, rows in zip(d["trace_steps"], d["trace_rows"]):
        passes = d["steps"][k]["passes"] or 0
        live = min(rows)
        total += head + passes * (p3.num_layers * layer + head + flops.kv_read_bytes(p3, live))
    sec = kernel_seconds(t, "int4_matvec_kernel", "decode_attn_kernel")
    return 100.0 * total / flops.HBM_BPS / sec if sec > 0 and total > 0 else None
