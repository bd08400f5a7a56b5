"""Published peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet,
dense rates, at its 700 W power limit): HBM bandwidth and the arithmetic
rate outside the tensor cores, by element size in bytes."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def bound_s(ops: float, nbytes: float, elem: int) -> tuple[float, str]:
    """(least seconds the card could take, 'bytes' or 'operations'): the
    larger of the bytes over the memory rate and the operations over the
    arithmetic rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[elem]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
