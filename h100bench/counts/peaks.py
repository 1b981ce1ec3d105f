"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet): tensor-core bf16, CUDA-core f32, HBM3 bandwidth. Copied from
``biscuit_torch/models/flops.py``. A card set below 700 W runs under them;
the run reports the card's power limit beside every share of them."""

PEAK_BF16 = 989e12          # FLOP/s
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": PEAK_BF16, "f32": PEAK_F32}


def bound_s(n_bytes: float, ops: dict):
    """(least seconds, 'bytes' or 'operations'): the larger of the HBM time
    of ``n_bytes`` and the slowest unit's time for ``ops`` ({'bf16' or
    'f32': operations}). The arithmetic of ``chip_smoke.py`` ``bound_ms``,
    in seconds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(v / PEAK[kind] for kind, v in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
