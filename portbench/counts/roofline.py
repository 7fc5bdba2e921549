"""The card's published peaks and the least time of a piece of work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
Copied from ``chip_smoke.py`` (``PEAK_*``, ``bound``, ``bound_f64``).
"""
from __future__ import annotations

PEAK_F32 = 67e12  # FP32 outside the tensor cores
PEAK_TF32 = 495e12  # TF32 on the tensor cores
PEAK_F64 = 34e12  # FP64 outside the tensor cores
PEAK_F64_PRODUCTS = 67e12  # FP64 matrix products on the tensor cores (DMMA)
PEAK_BYTES = 3.35e12  # HBM3


def bound(flops: float, nbytes: float, peak: float = PEAK_F32):
    """(seconds, bound_by): the larger of the operations' time at ``peak``
    (FP32 by default) and the memory time."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_f64(product_flops: float, other_flops: float, nbytes: float):
    """:func:`bound` for FP64 work: matrix products at the tensor cores' peak,
    the rest at the FP64 peak outside them."""
    return bound(product_flops / PEAK_F64_PRODUCTS * PEAK_F64 + other_flops, nbytes, PEAK_F64)
