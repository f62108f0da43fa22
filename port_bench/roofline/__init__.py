"""Peaks of one H100, and the least time of a call from its operations and
bytes (frozen from ``chip_smoke.py::bound_ms`` at 2a03127: each input byte
read once, each output byte written once; NVIDIA's SXM data sheet, dense
rates, at the 700 W limit)."""

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "fp8": 1979e12}


def bound_s(n_bytes: float, flops: float, kind: str) -> float:
    """The larger of bytes over bandwidth and operations over the peak of
    ``kind``, in seconds."""
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS[kind])
