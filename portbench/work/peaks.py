"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): HBM bytes/s and FLOP/s by type."""

HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def least_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time ``flops`` of ``dtype`` and ``nbytes`` of HBM traffic
    can take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BPS)
