"""Krylov-subspace (Lanczos) matrix-exponential action.

Counterpart of ``qiskit_dynamics_tpu/solvers/lanczos.py``. For an
anti-Hermitian generator ``A = -iH``, ``exp(dt A) y`` is approximated by
tridiagonalizing ``H`` in the Krylov space span{y, Hy, ..., H^(k-1)y} (with one
reorthogonalization correction per iteration for stability) and exponentiating
the small tridiagonal eigensystem.

- :func:`lanczos_basis`, :func:`lanczos_eigh`, :func:`lanczos_expm`: the host
  versions in numpy (they stop at a breakdown and return a smaller basis);
- :func:`jax_lanczos_expm`: the device version on tensors, with the JAX
  package's fixed shapes: after a breakdown (``beta`` no longer positive) the
  remaining basis vectors and coefficients are zero, so the tridiagonal stays
  ``(k_dim, k_dim)``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from scipy.sparse import csr_matrix

__all__ = ["lanczos_basis", "lanczos_eigh", "lanczos_expm", "jax_lanczos_expm"]


def lanczos_basis(A: Union[csr_matrix, np.ndarray], y0: np.ndarray, k_dim: int):
    """Tridiagonalize Hermitian ``A`` in a ``k_dim`` Krylov subspace (numpy).

    Returns ``(tridiagonal, q_basis)`` with ``q_basis`` of shape ``(n, k)``.
    """
    data_type = np.result_type(A.dtype, y0.dtype)
    y0 = np.asarray(y0).reshape(-1)
    n = A.shape[0]
    q_basis = np.zeros((k_dim, n), dtype=data_type)
    alpha = np.zeros(k_dim, dtype=data_type)
    beta = np.zeros(k_dim, dtype=data_type)

    q_basis[0] = y0
    projection = A @ y0
    alpha[0] = np.vdot(y0, projection)
    projection = projection - alpha[0] * y0
    beta[0] = np.linalg.norm(projection)

    eps = np.finfo(np.float64).eps
    for i in range(1, k_dim):
        if np.abs(beta[i - 1]) < eps:
            k_dim = i
            break
        v_prev = q_basis[i - 1]
        q_basis[i] = projection / beta[i - 1]
        projection = A @ q_basis[i]
        alpha[i] = np.vdot(q_basis[i], projection)
        projection = projection - alpha[i] * q_basis[i] - beta[i - 1] * v_prev
        # one reorthogonalization step for accuracy
        delta = np.vdot(q_basis[i], projection)
        projection = projection - delta * q_basis[i]
        alpha[i] = alpha[i] + delta
        beta[i] = np.linalg.norm(projection)

    tridiagonal = (
        np.diag(alpha[:k_dim])
        + np.diag(beta[: k_dim - 1], k=-1)
        + np.diag(beta[: k_dim - 1], k=1)
    )
    return tridiagonal, q_basis[:k_dim].T


def lanczos_eigh(A, y0, k_dim: int):
    """Eigendecomposition of the Krylov projection of Hermitian ``A``."""
    tridiagonal, q_basis = lanczos_basis(A, y0, k_dim)
    eigvals, eigvecs = np.linalg.eigh(tridiagonal)
    return q_basis, eigvals, eigvecs


def lanczos_expm(A, y0, k_dim: int, scale_factor: Optional[float] = 1.0):
    """``exp(scale_factor * A) @ y0`` for anti-Hermitian ``A`` (numpy)."""
    if y0.ndim == 1:
        H = 1j * A  # Hermitian
        norm = np.linalg.norm(y0)
        q_basis, eigvals, eigvecs = lanczos_eigh(H, y0 / norm, k_dim)
        return norm * (q_basis @ (eigvecs @ (np.exp(-1j * scale_factor * eigvals) * eigvecs[0])))
    cols = [lanczos_expm(A, yi, k_dim, scale_factor) for yi in np.asarray(y0).T]
    return np.array(cols).T


def _jax_lanczos_basis(A: torch.Tensor, y0: torch.Tensor, k_dim: int):
    """Lanczos tridiagonalization on tensors with fixed shapes: after a
    breakdown every further basis vector and coefficient is zero."""
    vdot = torch.vdot
    proj = A @ y0
    alpha = [vdot(y0, proj)]
    proj = proj - alpha[0] * y0
    beta = [torch.sqrt(torch.abs(vdot(proj, proj)))]
    qs = [y0]
    q_prev = y0
    for _ in range(k_dim - 1):
        live = beta[-1] > 0
        # a dead iteration divides by 1 and masks the result to zero
        q_i = torch.where(live, proj / torch.where(live, beta[-1], 1.0), 0.0)
        proj_i = A @ q_i
        alpha_i = vdot(q_i, proj_i)
        proj_i = proj_i - alpha_i * q_i - beta[-1] * q_prev
        delta = vdot(q_i, proj_i)
        proj_i = proj_i - delta * q_i
        alpha.append(torch.where(live, alpha_i + delta, 0.0))
        beta_i = torch.sqrt(torch.abs(vdot(proj_i, proj_i)))
        beta.append(torch.where(live, beta_i, 0.0))
        proj = torch.where(live, proj_i, 0.0)
        q_prev = q_i
        qs.append(q_i)
    alpha = torch.stack(alpha)
    beta = torch.stack(beta).to(alpha.dtype)
    tridiagonal = (
        torch.diag(alpha) + torch.diag(beta[: k_dim - 1], -1) + torch.diag(beta[: k_dim - 1], 1)
    )
    return tridiagonal, torch.stack(qs, dim=1)


def jax_lanczos_expm(A, y0, k_dim: int, scale_factor: Optional[float] = 1.0):
    """``exp(scale_factor * A) @ y0`` for anti-Hermitian ``A`` (tensors, on
    their device)."""
    if y0.ndim == 1:
        dtype = torch.promote_types(A.dtype, y0.dtype)
        H = 1j * A.to(dtype)
        norm = torch.linalg.vector_norm(y0)
        tridiagonal, q_basis = _jax_lanczos_basis(H, (y0 / norm).to(dtype), k_dim)
        eigvals, eigvecs = torch.linalg.eigh(tridiagonal)
        phases = torch.exp(-1j * scale_factor * eigvals).to(dtype)
        return norm * (q_basis @ (eigvecs @ (phases * eigvecs[0])))
    return torch.stack(
        [jax_lanczos_expm(A, yi, k_dim, scale_factor) for yi in y0.T], dim=1
    )
