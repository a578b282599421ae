"""Published peaks of the card, by the name ``torch.cuda.get_device_name``
gives: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full power limit of 700 W. A share of a peak is stated against these, with
the card's power limit beside it; the least time of a call is the roofline
bound at them (frozen from the port's card script, ``bound``)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                  "float32": 67e12, "float8": 1979e12},
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def peak(kind: str) -> dict:
    """The peaks of ``kind``; a card not in the table has none, and the
    shares of a peak are then not measured."""
    return PEAKS.get(kind)


def bound_s(nbytes: float, flops: float, flops_peak: float,
            bytes_peak: float) -> tuple[float, str]:
    """The least seconds a call can take: the larger of its operations over
    the peak rate and its bytes over the memory bandwidth, and which."""
    t_bytes = nbytes / bytes_peak
    t_ops = flops / flops_peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
