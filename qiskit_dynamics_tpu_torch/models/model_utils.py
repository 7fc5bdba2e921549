"""Column-stacking vectorization utilities.

Counterpart of ``qiskit_dynamics_tpu/models/model_utils.py``. In the
column-stacking convention ``vec(ABC) = (C^T kron A) vec(B)``.
"""
from __future__ import annotations

import torch

__all__ = ["vec_commutator", "vec_dissipator"]


def _batch_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """kron over the last two axes, broadcasting the leading axes."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(batch + a.shape[-2:])
    b = b.expand(batch + b.shape[-2:])
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(batch + (a.shape[-2] * b.shape[-2], a.shape[-1] * b.shape[-1]))


def vec_commutator(A: torch.Tensor) -> torch.Tensor:
    r"""Vectorization of ``X -> -i[A, X]``: ``-i(I kron A - A^T kron I)``.

    A ``(k, n, n)`` stack returns ``(k, n^2, n^2)``.
    """
    iden = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return -1j * (_batch_kron(iden, A) - _batch_kron(A.transpose(-1, -2), iden))


def vec_dissipator(L: torch.Tensor) -> torch.Tensor:
    r"""Vectorization of ``X -> L X L^dag - 1/2 {L^dag L, X}``:
    ``conj(L) kron L - 1/2 (I kron L^dag L + (L^dag L)^T kron I)``.

    A ``(k, n, n)`` stack returns ``(k, n^2, n^2)``.
    """
    iden = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Lconj = L.conj()
    LdagL = Lconj.transpose(-1, -2) @ L
    return _batch_kron(Lconj, L) - 0.5 * (
        _batch_kron(iden, LdagL) + _batch_kron(LdagL.transpose(-1, -2), iden)
    )
