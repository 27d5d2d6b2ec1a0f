"""The yardstick's arithmetic: device peaks, model FLOPs and kernel bytes,
all from shapes.

Peaks are the NVIDIA H100 SXM data sheet's dense rates (at its 700 W
limit): 989e12 FLOP/s bf16, 1979e12 OP/s int8, 67e12 FLOP/s float32 outside
the tensor cores, 3.35e12 B/s of HBM3.  Each run prints them beside the
card's power limit.
"""

from __future__ import annotations

import subprocess
from typing import Dict

BF16_PEAK = 989e12
INT8_PEAK = 1979e12
F32_PEAK = 67e12
HBM_BPS = 3.35e12

PEAKS = {"bf16_flops": BF16_PEAK, "int8_ops": INT8_PEAK, "f32_flops": F32_PEAK,
         "hbm_bytes_per_s": HBM_BPS}


def card_line() -> Dict:
    """``nvidia-smi``'s name and power limit of the card, with the peaks."""
    out = {"peaks": PEAKS}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        out["nvidia_smi"] = r.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = [f"unavailable: {e}"]
    return out


def card_state() -> str:
    """``nvidia-smi``'s SM clock, power draw and temperature now."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


# --- Phi-3 -------------------------------------------------------------------

def phi3_layer_params(p3) -> int:
    D, I = p3.hidden_size, p3.intermediate_size
    qkv = D * (p3.num_heads + 2 * p3.num_kv_heads) * p3.head_dim
    return qkv + p3.num_heads * p3.head_dim * D + D * 2 * I + I * D


def phi3_tokens_flops(p3, n_prompt: int, n_served: int) -> float:
    """Model FLOPs of a prompt of ``n_prompt`` valid tokens and the
    ``n_served`` tokens after it, each through every layer once (the served
    tokens' own last one excepted, which is never fed back), with causal
    attention, and the head once for each served token."""
    T = n_prompt + max(n_served - 1, 0)
    L, D = p3.num_layers, p3.hidden_size
    linear = 2.0 * L * phi3_layer_params(p3) * T
    attn = 2.0 * L * p3.num_heads * p3.head_dim * T * (T + 1)
    head = 2.0 * D * p3.vocab_size * n_served
    return linear + attn + head


def int4_bytes(d: int, n: int, dblk: int = 1024, nblk: int = 512) -> int:
    """Bytes of a packed int4 weight ``[d, n]``: the nibbles of the padded
    ``[Dp, Np]`` plus two f32 scale tables ``[Dp / dblk, Np / 2]``."""
    dp = -(-d // dblk) * dblk
    np_ = -(-n // (2 * nblk)) * (2 * nblk)
    n2 = np_ // 2
    return dp * n2 + 2 * (dp // dblk) * n2 * 4


def phi3_int4_layer_bytes(p3) -> Dict[str, int]:
    D, I = p3.hidden_size, p3.intermediate_size
    qkv_n = (p3.num_heads + 2 * p3.num_kv_heads) * p3.head_dim
    return {"qkv": int4_bytes(D, qkv_n), "o": int4_bytes(p3.num_heads * p3.head_dim, D),
            "gate_up": int4_bytes(D, 2 * I), "down": int4_bytes(I, D)}


def lm_head_bytes(p3) -> int:
    return int4_bytes(p3.hidden_size, p3.vocab_size)


def kv_read_bytes(p3, live: int) -> int:
    """K and V of ``live`` cached positions in bf16, every layer."""
    return 2 * p3.num_layers * live * p3.num_kv_heads * p3.head_dim * 2


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` as ``torch.utils.flop_counter``
    counts them from the shapes of its matrix products and convolutions."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return float(fc.get_total_flops())
