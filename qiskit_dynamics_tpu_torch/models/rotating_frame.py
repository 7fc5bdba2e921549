"""Rotating-frame transformations (dense).

Counterpart of ``qiskit_dynamics_tpu/models/rotating_frame.py``. The frame
is an anti-Hermitian operator ``F = -iH``, eigendecomposed ONCE at
construction; every transform is then an elementwise phase multiply in the
frame eigenbasis:

- state into/out of frame: ``exp(-+ tF) y`` = diagonal multiply;
- operator conjugation ``exp(-tF) G exp(tF)`` = Hadamard product with the
  rank-1 phase matrix ``conj(e) e^T`` where ``e = exp(t d)``.

The frame lives on an explicit ``device`` in an explicit complex ``dtype``.
Operators and states given as numpy arrays, lists or tensors are converted
to tensors on that device, in that dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import complex_dtype
from ..exceptions import DynamicsError
from ..unified import default_device, to_numpy, to_tensor

__all__ = ["RotatingFrame"]


def _enforce_anti_herm(mat: np.ndarray, atol: float = 1e-10, rtol: float = 1e-10):
    """Anti-Hermitian version of a host matrix (or 1-d diagonal).

    Hermitian input -> ``-1j * mat``; anti-Hermitian input -> unchanged; any
    other input raises.
    """
    mat = np.asarray(mat).astype(np.result_type(mat.dtype, np.complex64))
    adj = np.conj(mat) if mat.ndim == 1 else np.conj(mat).T
    if np.allclose(mat, adj, atol=atol, rtol=rtol):
        return -1j * mat
    if np.allclose(mat, -adj, atol=atol, rtol=rtol):
        return mat
    raise DynamicsError("frame_operator must be either a Hermitian or anti-Hermitian matrix.")


class RotatingFrame:
    r"""Rotating frame specified by an anti-Hermitian operator ``F = -iH``.

    Can be instantiated with ``None`` (trivial frame), a 1-d array (diagonal
    ``H`` or ``F``), or a 2-d Hermitian/anti-Hermitian array (eigendecomposed
    once at construction, in complex128 on the host). ``device=None`` is the
    CUDA device (raises without one); pass ``device="cpu"`` for the host.
    """

    def __init__(
        self,
        frame_operator,
        atol: float = 1e-10,
        rtol: float = 1e-10,
        device=None,
        dtype: torch.dtype = torch.complex128,
    ):
        if isinstance(frame_operator, RotatingFrame):
            frame_operator = frame_operator.frame_operator
        self._device = default_device(device)
        self._dtype = complex_dtype(dtype)
        self._frame_operator = frame_operator
        self._frame_basis = None
        self._frame_basis_adjoint = None
        self._vectorized_frame_basis = None
        self._vectorized_frame_basis_adjoint = None

        if frame_operator is None:
            self._dim = None
            self._frame_diag = None
            return

        anti_herm = _enforce_anti_herm(to_numpy(frame_operator), atol=atol, rtol=rtol)
        if anti_herm.ndim == 1:
            frame_diag = anti_herm
        else:
            # one-time diagonalization: iF is Hermitian
            evals, basis = torch.linalg.eigh(torch.as_tensor(1j * anti_herm, dtype=torch.complex128))
            frame_diag = -1j * evals.numpy()
            self._frame_basis = self._tensor(basis)
            self._frame_basis_adjoint = self._frame_basis.conj().T.contiguous()
        self._frame_diag = self._tensor(frame_diag)
        self._dim = self._frame_diag.shape[0]

    def _tensor(self, x) -> torch.Tensor:
        """``x`` as a tensor on the frame's device in the frame's dtype."""
        return to_tensor(x, device=self._device).to(self._dtype)

    # --- properties -----------------------------------------------------
    @property
    def dim(self) -> Optional[int]:
        """Dimension of the frame."""
        return self._dim

    @property
    def device(self) -> torch.device:
        """Device holding the frame's tensors."""
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        """Complex dtype of the frame's tensors."""
        return self._dtype

    @property
    def frame_operator(self):
        """The original frame operator."""
        return self._frame_operator

    @property
    def frame_diag(self) -> Optional[torch.Tensor]:
        """Eigenvalues of the frame operator (purely imaginary)."""
        return self._frame_diag

    @property
    def frame_basis(self) -> Optional[torch.Tensor]:
        """Diagonalizing unitary (None for trivial/diagonal frames)."""
        return self._frame_basis

    @property
    def frame_basis_adjoint(self) -> Optional[torch.Tensor]:
        """Adjoint of the diagonalizing unitary."""
        return self._frame_basis_adjoint

    # --- frame basis transforms -------------------------------------------
    def state_into_frame_basis(self, y) -> torch.Tensor:
        """``frame_basis_adjoint @ y``."""
        y = self._tensor(y)
        if self._frame_basis_adjoint is None:
            return y
        return self._frame_basis_adjoint @ y

    def state_out_of_frame_basis(self, y) -> torch.Tensor:
        """``frame_basis @ y``."""
        y = self._tensor(y)
        if self._frame_basis is None:
            return y
        return self._frame_basis @ y

    def operator_into_frame_basis(self, op) -> Optional[torch.Tensor]:
        """``frame_basis_adjoint @ op @ frame_basis`` (broadcasts over stacked ops)."""
        if op is None:
            return None
        op = self._tensor(op)
        if self._frame_basis is None:
            return op
        return self._frame_basis_adjoint @ (op @ self._frame_basis)

    def operator_out_of_frame_basis(self, op) -> Optional[torch.Tensor]:
        """``frame_basis @ op @ frame_basis_adjoint`` (broadcasts over stacked ops)."""
        if op is None:
            return None
        op = self._tensor(op)
        if self._frame_basis is None:
            return op
        return self._frame_basis @ (op @ self._frame_basis_adjoint)

    # --- state transforms -------------------------------------------------
    def _phases(self, t, dtype) -> torch.Tensor:
        """``exp(t d)`` for the frame diagonal ``d``, in ``dtype``."""
        t = torch.as_tensor(t, dtype=torch.float64)
        return torch.exp(t * self._frame_diag.to(torch.complex128)).to(dtype)

    def state_into_frame(
        self, t, y, y_in_frame_basis: bool = False, return_in_frame_basis: bool = False
    ) -> torch.Tensor:
        """``exp(-tF) @ y`` via diagonal phase multiply in the frame basis."""
        y = self._tensor(y)
        if self._frame_operator is None:
            return y
        out = y if y_in_frame_basis else self.state_into_frame_basis(y)
        # multiply along axis 0 (dim axis); supports (dim,) and (dim, m)
        phase = self._phases(-torch.as_tensor(t, dtype=torch.float64), out.dtype)
        out = phase.reshape((-1,) + (1,) * (out.ndim - 1)) * out
        if not return_in_frame_basis:
            out = self.state_out_of_frame_basis(out)
        return out

    def state_out_of_frame(
        self, t, y, y_in_frame_basis: bool = False, return_in_frame_basis: bool = False
    ) -> torch.Tensor:
        """``exp(tF) @ y``."""
        return self.state_into_frame(
            -torch.as_tensor(t, dtype=torch.float64), y, y_in_frame_basis, return_in_frame_basis
        )

    # --- operator transforms ---------------------------------------------
    def _conjugate_and_add(
        self,
        t,
        operator,
        op_to_add_in_fb=None,
        operator_in_frame_basis: bool = False,
        return_in_frame_basis: bool = False,
        vectorized_operators: bool = False,
    ) -> torch.Tensor:
        r"""``exp(-tF) G exp(tF) + B`` (``B`` added in the frame basis);
        ``(k, dim, dim)`` stacks broadcast. With ``vectorized_operators``
        the operators are column-stacked ``(dim^2,)`` vectors or
        ``(dim^2, k)`` stacks of them, and so is the result."""
        operator = self._tensor(operator)
        if self._frame_operator is None:
            if op_to_add_in_fb is None:
                return operator
            return operator + self._tensor(op_to_add_in_fb)
        if vectorized_operators:
            if operator.ndim == 2:
                operator = operator.T
            operator = _unvec(operator, self._dim)

        out = operator
        if not operator_in_frame_basis:
            out = self.operator_into_frame_basis(out)

        # rank-1 phase matrix: conj(e)_i e_j with e = exp(t d)
        exp_freq = self._phases(t, out.dtype)
        out = out * (exp_freq.conj()[:, None] * exp_freq[None, :])

        if op_to_add_in_fb is not None:
            out = out + self._tensor(op_to_add_in_fb)

        if not return_in_frame_basis:
            out = self.operator_out_of_frame_basis(out)
        if vectorized_operators:
            out = _vec(out)
            if out.ndim == 2:
                out = out.T
        return out

    def operator_into_frame(
        self, t, operator, operator_in_frame_basis: bool = False,
        return_in_frame_basis: bool = False, vectorized_operators: bool = False,
    ) -> torch.Tensor:
        """``exp(-tF) @ operator @ exp(tF)``."""
        return self._conjugate_and_add(
            t, operator, operator_in_frame_basis=operator_in_frame_basis,
            return_in_frame_basis=return_in_frame_basis,
            vectorized_operators=vectorized_operators,
        )

    def operator_out_of_frame(
        self, t, operator, operator_in_frame_basis: bool = False,
        return_in_frame_basis: bool = False, vectorized_operators: bool = False,
    ) -> torch.Tensor:
        """``exp(tF) @ operator @ exp(-tF)``."""
        return self.operator_into_frame(
            -torch.as_tensor(t, dtype=torch.float64), operator,
            operator_in_frame_basis=operator_in_frame_basis,
            return_in_frame_basis=return_in_frame_basis,
            vectorized_operators=vectorized_operators,
        )

    def generator_into_frame(
        self, t, operator, operator_in_frame_basis: bool = False,
        return_in_frame_basis: bool = False,
    ) -> torch.Tensor:
        """``exp(-tF) @ operator @ exp(tF) - F``."""
        if self._frame_operator is None:
            return self._tensor(operator)
        return self._conjugate_and_add(
            t, operator, op_to_add_in_fb=-torch.diag(self._frame_diag),
            operator_in_frame_basis=operator_in_frame_basis,
            return_in_frame_basis=return_in_frame_basis,
        )

    # --- vectorized (dim^2) support ---------------------------------------
    @property
    def vectorized_frame_basis(self) -> Optional[torch.Tensor]:
        """``kron(conj(C), C)`` for column-stacked operators (built on first use)."""
        if self._frame_basis is None:
            return None
        if self._vectorized_frame_basis is None:
            self._vectorized_frame_basis = torch.kron(self._frame_basis.conj(), self._frame_basis)
            self._vectorized_frame_basis_adjoint = (
                self._vectorized_frame_basis.conj().T.contiguous()
            )
        return self._vectorized_frame_basis

    @property
    def vectorized_frame_basis_adjoint(self) -> Optional[torch.Tensor]:
        """Adjoint of :attr:`vectorized_frame_basis`."""
        if self._frame_basis is None:
            return None
        if self._vectorized_frame_basis_adjoint is None:
            _ = self.vectorized_frame_basis
        return self._vectorized_frame_basis_adjoint

    def vectorized_map_into_frame(
        self, time, op, operator_in_frame_basis: bool = False,
        return_in_frame_basis: bool = False,
    ) -> torch.Tensor:
        r"""Frame map of a column-stacked ``(dim^2, dim^2)`` superoperator:
        ``(e^{tF}^T (x) e^{-tF}) op (e^{-tF}^T (x) e^{tF})``, a Hadamard
        product with the flattened rank-1 phase outer product."""
        op = self._tensor(op)
        if self._frame_diag is None:
            return op
        if not operator_in_frame_basis and self._frame_basis is not None:
            op = self.vectorized_frame_basis_adjoint @ (op @ self.vectorized_frame_basis)
        expvals = self._phases(time, op.dtype)
        temp_outer = (expvals.conj()[:, None] * expvals[None, :]).reshape(-1)
        op = (temp_outer.conj()[:, None] * temp_outer[None, :]) * op
        if not return_in_frame_basis and self._frame_basis is not None:
            op = self.vectorized_frame_basis @ (op @ self.vectorized_frame_basis_adjoint)
        return op


def _vec(x: torch.Tensor) -> torch.Tensor:
    """Column-stacking vec of the last two axes: (..., n, n) -> (..., n^2)."""
    return x.transpose(-1, -2).reshape(x.shape[:-2] + (-1,))


def _unvec(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`_vec`: (..., n^2) -> (..., n, n)."""
    return x.reshape(x.shape[:-1] + (dim, dim)).transpose(-1, -2)
