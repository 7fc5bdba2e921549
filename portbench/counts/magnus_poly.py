"""A fixed-step Magnus sweep through its polynomial expansion (the port's
polynomial engine): the step matrix is a polynomial in the members' Gauss
coefficients, ``M_b = sum_q mono_q(c_b) X_q`` with ``Q`` member-independent
matrices ``X_q`` shared by every step, so per member and step the work is
the monomials, the contraction with the ``X_q`` (real monomials against
complex matrices: 4 flops per entry and monomial), the two diagonal frame
rotations of the state, and the Horner Taylor polynomial applied to the
state.

The bytes are the inputs read once (the float32 coefficient table, the
``X_q`` as float32 planes, the frame diagonal, the initial state) and the
final states written once. Unlike ``chip_smoke.py``'s bound of kernel B4,
the step matrices ``M_b`` (1.07 GB a step at 2,048 members of n = 256) are
not counted: they are an intermediate of today's implementation, and a
kernel that forms them on chip does the same work.
"""
from __future__ import annotations

import itertools


def monomials(magnus_order: int, k: int) -> set:
    """The monomials of the Magnus bracket polynomial in the
    ``magnus_order * k`` Gauss coefficients (the constant term included), as
    sorted tuples of variables, as the expansion forms them: a product of two
    terms has the sorted union of their variables; terms that cancel
    numerically still count."""
    nodes = range(magnus_order)
    gens = [{(), *((i * k + j,) for j in range(k))} for i in nodes]

    def prod(p, q):
        return {tuple(sorted(a + b)) for a, b in itertools.product(p, q)}

    def comm(p, q):
        return prod(p, q) | prod(q, p)

    if magnus_order == 2:
        a1, a2 = gens
        return a1 | a2 | comm(a2, a1)
    a1, a2, a3 = gens  # the 6th-order rule's alpha_1, alpha_2, alpha_3 span:
    x1, x2, x3 = a2, a3 | a1, a3 | a2 | a1
    c1 = comm(x1, x2)
    c2 = comm(x3 | c1, x1)
    return x1 | x3 | comm(x1 | x3 | c1, x2 | c2)


def work(shape: dict):
    """(flops, bytes) of one call; ``shape``: n, k, order, steps, members,
    magnus_order."""
    n, k, T, B = shape["n"], shape["k"], shape["steps"], shape["members"]
    nodes = shape["magnus_order"]
    monos = monomials(nodes, k)
    q = len(monos)
    products = sum(max(0, len(m) - 1) for m in monos)
    per_member_step = (products + 4 * q * n * n + 12 * n
                       + shape["order"] * (8 * n * n + 4 * n))
    flops = per_member_step * T * B
    nbytes = 4 * T * nodes * k * B + 8 * q * n * n + 8 * n + 8 * n + 8 * B * n
    return flops, nbytes
