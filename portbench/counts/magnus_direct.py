"""A fixed-step Magnus-2 sweep evaluated member by member (kernel B2's
algorithm): per member and step, the generators at the two Gauss points
from ``k`` coefficients, the commutator (one complex product when the
generators are anti-Hermitian, two otherwise), and the Taylor polynomial of
the step's exponential applied to the state by Horner's rule.

Copied from ``chip_smoke.py`` (``b2_flops_per_member_step``, ``b2_bound``)
unchanged: the inputs are the float32 coefficient table, the initial states
and the operators, the output the final states.
"""
from __future__ import annotations


def flops_per_member_step(n: int, k: int, order: int, hermitian: bool) -> float:
    build = 2 * n * n * (4 * k + 6)
    horner = order * (8 * n * n + 4 * n)
    if hermitian:
        return build + 8 * n**3 + 10 * n * n + horner
    return build + 16 * n**3 + 12 * n * n + horner


def work(shape: dict):
    """(flops, bytes) of one call; ``shape``: n, k, order, steps, members,
    magnus_order (2), hermitian."""
    if shape["magnus_order"] != 2:
        raise ValueError("magnus_direct counts the Magnus-2 rule")
    n, k, T, B = shape["n"], shape["k"], shape["steps"], shape["members"]
    flops = flops_per_member_step(n, k, shape["order"], shape["hermitian"]) * T * B
    nbytes = 4 * (T * 2 * k * B + 4 * n * B + 2 * (k + 1) * n * n) + 8 * n * n
    return flops, nbytes
