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

:func:`expm_pade` is the norm-adaptive scaling and squaring of Higham (2005)
that ``jax.scipy.linalg.expm`` implements (the JAX package's
``expm_method="pade"``), batched over leading axes in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

__all__ = ["expm_pade", "expm_taylor", "taylor_coefficients"]


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


# Pade numerator coefficients b_0..b_m of degrees 3, 5, 7, 9, 13 (Higham 2005)
_PADE_B = {
    3: (120.0, 60.0, 12.0, 1.0),
    5: (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0),
    7: (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0),
    9: (17643225600.0, 8821612800.0, 2075673600.0, 302702400.0, 30270240.0, 2162160.0,
        110880.0, 3960.0, 90.0, 1.0),
    13: (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
         1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
         33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0),
}
# per precision: the 1-norm above which the matrix is scaled, the 1-norm
# thresholds between degrees, and the degrees
_PADE_DOUBLE = (5.371920351148152,
                (1.495585217958292e-2, 2.539398330063230e-1, 9.504178996162932e-1,
                 2.097847961257068e0),
                (3, 5, 7, 9, 13))
_PADE_SINGLE = (3.925724783138660, (4.258730016922831e-1, 1.880152677804762e0), (3, 5, 7))


def _pade_uv(A: torch.Tensor, degree: int):
    """Odd (``U``) and even (``V``) parts of the degree-``degree`` Pade
    numerator at ``A`` (..., n, n), in the products of ``jax.scipy``."""
    b = _PADE_B[degree]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    if degree == 13:
        A4 = A2 @ A2
        A6 = A4 @ A2
        U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
                 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
        V = A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4 + b[2] * A2 \
            + b[0] * eye
        return U, V
    powers = [eye, A2]  # A^0, A^2, A^4, ...
    for _ in range(2, degree // 2 + 1):
        powers.append(powers[-1] @ A2)
    U = A @ sum(b[2 * i + 1] * powers[i] for i in range(degree // 2, -1, -1))
    V = sum(b[2 * i] * powers[i] for i in range(degree // 2, -1, -1))
    return U, V


def expm_pade(A: torch.Tensor, max_squarings: int = 16) -> torch.Tensor:
    """Batched ``expm`` by Pade approximation with scaling and squaring.

    The algorithm of ``jax.scipy.linalg.expm``, decided for each matrix of
    the batch: its 1-norm picks the Pade degree (3, 5, 7, 9 or 13 in
    float64/complex128; 3, 5 or 7 in float32/complex64, with their own
    thresholds) and the number of squarings ``max(0, floor(log2(|A|_1 /
    maxnorm)))``; then ``R = Q^-1 P`` is squared that many times. A matrix
    that needs more than ``max_squarings`` squarings comes back as NaN, as in
    JAX.

    Args:
        A: (..., n, n) real or complex floating tensor, on any device.
        max_squarings: the largest number of squarings allowed.

    Returns:
        (..., n, n) matrix exponentials, on ``A``'s device and in its dtype.
    """
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected a (batched) square matrix, got shape {tuple(A.shape)}")
    if A.dtype in (torch.float64, torch.complex128):
        maxnorm, conds, degrees = _PADE_DOUBLE
    elif A.dtype in (torch.float32, torch.complex64):
        maxnorm, conds, degrees = _PADE_SINGLE
    else:
        raise TypeError(f"expm_pade takes float32/64 or complex64/128, got {A.dtype}")
    shape = A.shape
    A = A.reshape(-1, shape[-1], shape[-1])
    norm = torch.linalg.matrix_norm(A, ord=1)  # (N,) real, max column sum
    squarings = torch.clamp(torch.floor(torch.log2(norm / maxnorm)), min=0.0)
    A = A / (2.0 ** squarings).to(A.dtype)[:, None, None]
    idx = torch.bucketize(norm, torch.tensor(conds, dtype=norm.dtype, device=norm.device),
                          right=True)
    P = torch.empty_like(A)
    Q = torch.empty_like(A)
    for i in torch.unique(idx).tolist():
        sel = (idx == i).nonzero().squeeze(-1)
        U, V = _pade_uv(A[sel], degrees[i])
        P[sel] = U + V
        Q[sel] = V - U
    R = torch.linalg.solve(Q, P)
    most = int(squarings.max().clamp(max=max_squarings).item()) if len(R) else 0
    for s in range(most):
        R = torch.where((s < squarings)[:, None, None], R @ R, R)
    R = torch.where((squarings > max_squarings)[:, None, None],
                    torch.full_like(R, float("nan")), R)
    return R.reshape(shape)
