"""A perturbative (Dysolve) sweep: the port's ``DysonSolver`` and
``MagnusSolver.solve_sweep``. Every step of every member evaluates the
precomputed expansion, a polynomial in the step's Chebyshev coefficients
with ``M`` member-independent (n, n) matrices; for Magnus the step's
propagator is ``Udt expm(polynomial)``; the members' states are carried
through their ``T`` step propagators.

Per lane (one step of one member), the least operations:

- the monomials: one product for each of degree two and up, each formed from
  one of the degree below (``M - variables``);
- the contraction: real monomials against complex matrices, 4 flops per
  monomial and matrix entry;
- Magnus only: the Taylor-12 ``expm`` by Horner's rule with its one squaring,
  ``(12 - 1 + 1)`` complex products (8 n^3 each), and the ``Udt`` product;
- the chain: the propagator applied to the state, 8 n^2.

The bytes are the inputs read once (the float32 coefficient table, the
expansion's matrices, ``Udt`` and ``y0`` in complex64) and the final states
written once. Today's intermediates (the monomial table, the product's lanes
and the step propagators) are not counted.
"""
from __future__ import annotations

import math

EXPM_ORDER = 12  # perturbative_solver._MAGNUS_EXPM_ORDER
EXPM_SQUARINGS = 1  # solve_sweep's default


def variables(k: int, chebyshev_order: int) -> int:
    """The Chebyshev variables of ``k`` signals: the real and imaginary
    envelope's coefficients, ``chebyshev_order + 1`` each."""
    return 2 * k * (chebyshev_order + 1)


def monomials(expansion_order: int, n_vars: int) -> int:
    """The expansion's non-constant terms: the multisets of 1 to
    ``expansion_order`` of the ``n_vars`` variables."""
    return math.comb(n_vars + expansion_order, expansion_order) - 1


def flops_per_lane(n: int, method: str, terms: int, n_vars: int) -> float:
    flops = (terms - n_vars) + 4 * terms * n * n + 8 * n * n
    if method == "magnus":
        flops += (EXPM_ORDER - 1 + EXPM_SQUARINGS + 1) * 8 * n**3
    elif method != "dyson":
        raise ValueError(f"unknown expansion method {method!r}")
    return flops


def nbytes(n: int, method: str, terms: int, n_vars: int, lanes: int, members: int) -> float:
    """The coefficient table (float32), the expansion's matrices, ``Udt``
    (Magnus) and ``y0`` (complex64) read once, the final states written once."""
    udt = 8 * n * n if method == "magnus" else 0
    return 4 * n_vars * lanes + 8 * terms * n * n + udt + 8 * n + 8 * n * members


def work(shape: dict):
    """(flops, bytes) of one call; ``shape``: n, k, steps, members,
    expansion_method, expansion_order, chebyshev_order."""
    n, method = shape["n"], shape["expansion_method"]
    n_vars = variables(shape["k"], shape["chebyshev_order"])
    terms = monomials(shape["expansion_order"], n_vars)
    lanes = shape["steps"] * shape["members"]
    return (flops_per_lane(n, method, terms, n_vars) * lanes,
            nbytes(n, method, terms, n_vars, lanes, shape["members"]))
