"""Kernel C (``csrc/nerf_mlp.cu``, the renderer's NeRF MLP) against the
larger of its two bounds in the traced iterations: each launch runs one
novel view's rays times kept samples through the MLP
(``flops_fields.nerf_mlp_bound_s``); launches from ``ops.kernels.launches``
over the window, over the device time of ``nerf_mlp_kernel``."""

from perfbench import flops_fields
from perfbench.trace import kernel_seconds


def read(d):
    t, n = d["trace"], d.get("trace_launches") or {}
    if not t or not n.get("nerf_mlp"):
        return None
    f = d["fields"]
    bound = n["nerf_mlp"] * flops_fields.nerf_mlp_bound_s(flops_fields.render_rows(f), f.fts_dim)
    sec = kernel_seconds(t, "nerf_mlp_kernel")
    return 100.0 * bound / sec if sec > 0 else None
