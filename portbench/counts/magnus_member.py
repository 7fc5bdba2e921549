"""A fixed-step Magnus-2/3 sweep member by member, each member's matrices
kept on chip (kernel B3's algorithm, ``csrc/member_sweep.cu``): per member
and step, the generators at the Gauss points from ``k`` coefficients, the
brackets of the step rule (complex products of 8 n^3 operations each: one at
Magnus-2 with ``hermitian``, two per bracket otherwise, as the kernel forms
them), the Magnus assembly and the Horner mat-vecs of the step's exponential
applied to the state; once per step the frame-rotated tables.

Moved from ``chip_smoke.py`` (``b3_bounds``, ``b3_bound``) unchanged, at the
state dimension n itself (not the kernel's padded tiles). The inputs are the
float32 coefficient table, the initial states, the static and operator
tables and the frame phases; the output the final states.

:func:`work` counts every operation at the FP32 rate outside the tensor
cores. :func:`tf32x3` is the bound B3's design is held to: its products run
on the tensor cores as three TF32 passes (3xTF32, float32 accuracy), so they
are counted three times at the TF32 peak, the rest at the FP32 rate.
"""
from __future__ import annotations

from .roofline import PEAK_F32, PEAK_TF32, bound


def counts(shape: dict):
    """(product_flops, other_flops, bytes) of one call; ``shape``: n, k,
    order, steps, members, magnus_order, hermitian."""
    n, k, T, B = shape["n"], shape["k"], shape["steps"], shape["members"]
    magnus = shape["magnus_order"]
    if magnus not in (2, 3):
        raise ValueError(f"magnus_member counts the Magnus-2 and -3 rules, not {magnus!r}")
    products = 1 if magnus == 2 and shape["hermitian"] else 2 if magnus == 2 else 6
    assembly = (8 if magnus == 2 else 40) * n * n
    product_flops = products * 8 * n**3 * T * B
    other_flops = ((shape["order"] * 8 * n * n + magnus * 4 * k * n * n + assembly) * T * B
                   + T * magnus * (k + 1) * 6 * n * n)
    nbytes = 4 * T * magnus * k * B + 16 * n * B + 8 * (k + 1) * n * n + 8 * n * n
    return product_flops, other_flops, nbytes


def work(shape: dict):
    """(flops, bytes) of one call, every operation counted at FP32."""
    product_flops, other_flops, nbytes = counts(shape)
    return product_flops + other_flops, nbytes


def tf32x3(shape: dict):
    """(seconds, bound_by) of one call at the bound B3 is held to: the
    products as three TF32 passes at the tensor cores' peak, the rest at the
    FP32 peak, or the bytes at the HBM peak."""
    product_flops, other_flops, nbytes = counts(shape)
    return bound(3 * product_flops / PEAK_TF32 * PEAK_F32 + other_flops, nbytes)
