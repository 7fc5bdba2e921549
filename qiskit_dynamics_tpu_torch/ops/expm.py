r"""Branch-free batched matrix exponentials for fixed-step solvers.

Counterpart of ``qiskit_dynamics_tpu/ops/expm.py``. For fixed-step solvers
the step generators have a known norm bound (``max_dt`` times a generator
scale), so a fixed-order Taylor with a static number of squarings is exact
to working precision. The polynomial is evaluated Paterson-Stockmeyer
style, so a degree-12 Taylor costs 5 matrix products instead of Horner's 11.
The products are batched ``torch.matmul`` calls (the JAX package leaves them
to XLA outside any Pallas kernel).

Error bound: for ``theta = ||A|| / 2**squarings``, the truncation error is
``~ theta**(order+1) / (order+1)!``; the default (order=12, squarings=2)
gives < 1e-12 relative error for ``||A|| <= 4``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["expm_taylor", "taylor_coefficients"]


def taylor_coefficients(order: int):
    """``1 / k!`` for ``k = 0 .. order``."""
    return [1.0 / math.factorial(k) for k in range(order + 1)]


def expm_taylor(A: torch.Tensor, order: int = 12, squarings: int = 2) -> torch.Tensor:
    """Batched ``expm`` via fixed-order Taylor + static scaling-and-squaring.

    The same coefficients and evaluation order as the JAX package: plain
    Horner below order 6; from order 6 Paterson-Stockmeyer blocking (the
    powers up to ``X^s``, ``s = max(2, isqrt(order))``, then Horner in
    ``X^s``, the top block folded into the first step when it is ``c I``):
    ``(s - 1) + ceil((order + 1) / s) - 1`` products.

    Args:
        A: (..., n, n) complex tensor (any leading batch dims).
        order: Taylor order.
        squarings: static number of scaling/squaring steps; accurate while
            ``norm(A) / 2**squarings`` stays of order one.

    Returns:
        (..., n, n) matrix exponentials, on ``A``'s device and in its dtype.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    X = A / (2.0**squarings)

    if order < 6:
        P = eye + X / order
        for k in range(order - 1, 0, -1):
            P = eye + (X @ P) / k
    else:
        s = max(2, math.isqrt(order))
        powers = [eye, X]
        for _ in range(2, s + 1):
            powers.append(powers[-1] @ X)
        Xs = powers[s]
        coeff = taylor_coefficients(order)

        def block(j):
            """B_j = sum_i c_{js+i} X^i (i < s): scalar-matrix combinations."""
            out = None
            for i in range(s):
                k = s * j + i
                if k > order:
                    break
                term = coeff[k] * powers[i]
                out = term if out is None else out + term
            return out

        m = -(-(order + 1) // s) - 1  # index of the top block
        if s * m == order:  # the top block is c I: fold it into the first step
            P = block(m - 1) + coeff[order] * Xs
            m -= 1
        else:
            P = block(m)
        for j in range(m - 1, -1, -1):
            P = block(j) + Xs @ P

    for _ in range(squarings):
        P = P @ P
    return P
