"""Operator collections: the RHS math (dense).

Counterpart of the dense ``OperatorCollection`` and
``VectorizedLindbladCollection`` in
``qiskit_dynamics_tpu/models/operator_collections.py``. The sparse
collections and the non-vectorized ``LindbladCollection`` are still to be
ported (``ROADMAP.md``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..unified import to_numpy, to_tensor
from .model_utils import vec_commutator, vec_dissipator

__all__ = ["OperatorCollection", "VectorizedLindbladCollection"]


class OperatorCollection:
    r"""Evaluates ``Lambda(c, y) = (G_d + Sigma_j c_j G_j) y``.

    ``operators`` is a ``(k, n, n)`` tensor; ``static_operator`` is ``(n, n)``.
    Both are kept as given (the model converts them to its device/dtype).
    """

    def __init__(
        self,
        static_operator: Optional[torch.Tensor] = None,
        operators: Optional[torch.Tensor] = None,
    ):
        self._static_operator = static_operator
        self._operators = operators

    @property
    def dim(self) -> int:
        """Matrix dimension."""
        if self._static_operator is not None:
            return self._static_operator.shape[-1]
        return self._operators.shape[-1]

    @property
    def static_operator(self) -> Optional[torch.Tensor]:
        """The static operator ``G_d``."""
        return self._static_operator

    @property
    def operators(self) -> Optional[torch.Tensor]:
        """The operator stack ``G_j``."""
        return self._operators

    @functools.cached_property
    def anti_hermitian(self) -> bool:
        """Whether every operator is anti-Hermitian (``G = -iH``) to 1e-12 of
        its largest entry. Checked once, on host copies; the operators are
        never replaced, so the answer is kept."""
        mats = [] if self._static_operator is None else [self._static_operator]
        if self._operators is not None:
            mats.extend(self._operators)
        for a in mats:
            a = to_numpy(a)
            scale = max(1.0, float(np.max(np.abs(a))))
            if not np.allclose(a, -a.conj().T, rtol=0.0, atol=1e-12 * scale):
                return False
        return True

    def _coefficients(self, coefficients) -> torch.Tensor:
        return to_tensor(coefficients).to(
            device=self._operators.device, dtype=self._operators.dtype
        )

    def evaluate(self, coefficients) -> torch.Tensor:
        r"""Return ``G_d + Sigma_j c_j G_j``."""
        if self._operators is not None:
            combo = torch.tensordot(self._coefficients(coefficients), self._operators, dims=1)
            if self._static_operator is not None:
                return combo + self._static_operator
            return combo
        if self._static_operator is not None:
            return self._static_operator
        raise DynamicsError(
            "OperatorCollection with None for both static_operator and operators "
            "cannot be evaluated."
        )

    def evaluate_rhs(self, coefficients, y: torch.Tensor) -> torch.Tensor:
        r"""Return ``(G_d + Sigma_j c_j G_j) y``.

        For 1d ``y`` the operators are multiplied into the state before the
        linear combination (``Sigma_j c_j (G_j y)``), as the JAX package does.
        """
        if y.ndim == 1 and self._operators is not None:
            op_dot_y = torch.tensordot(self._operators, y, dims=([2], [0]))  # (k, n)
            rhs = torch.tensordot(self._coefficients(coefficients), op_dot_y, dims=([0], [0]))
            if self._static_operator is not None:
                rhs = rhs + self._static_operator @ y
            return rhs
        return self.evaluate(coefficients) @ y

    def __call__(self, coefficients, y=None) -> torch.Tensor:
        if y is None:
            return self.evaluate(coefficients)
        return self.evaluate_rhs(coefficients, y)


class VectorizedLindbladCollection:
    r"""Column-stacking vectorized Lindblad collection (dense).

    Precomputes the ``(n^2, n^2)`` superoperators with :func:`vec_commutator`
    and :func:`vec_dissipator` and delegates to an inner
    :class:`OperatorCollection` over the concatenated
    ``[hamiltonian, dissipator]`` coefficients. Operators are tensors, kept
    on their device and in their dtype (the model places them).
    """

    def __init__(
        self,
        static_hamiltonian: Optional[torch.Tensor] = None,
        hamiltonian_operators: Optional[torch.Tensor] = None,
        static_dissipators: Optional[torch.Tensor] = None,
        dissipator_operators: Optional[torch.Tensor] = None,
    ):
        self._static_hamiltonian = static_hamiltonian
        self._hamiltonian_operators = hamiltonian_operators
        self._static_dissipators = static_dissipators
        self._dissipator_operators = dissipator_operators

        static_operator = None
        if static_hamiltonian is not None:
            static_operator = vec_commutator(static_hamiltonian)
        if static_dissipators is not None:
            sd = torch.sum(vec_dissipator(static_dissipators), dim=0)
            static_operator = sd if static_operator is None else static_operator + sd

        op_list = []
        if hamiltonian_operators is not None:
            op_list.append(vec_commutator(hamiltonian_operators))
        if dissipator_operators is not None:
            op_list.append(vec_dissipator(dissipator_operators))
        operators = torch.cat(op_list, dim=0) if op_list else None
        self._operator_collection = OperatorCollection(
            static_operator=static_operator, operators=operators
        )

    @property
    def static_hamiltonian(self) -> Optional[torch.Tensor]:
        """Static Hamiltonian term."""
        return self._static_hamiltonian

    @property
    def hamiltonian_operators(self) -> Optional[torch.Tensor]:
        """Hamiltonian operator stack."""
        return self._hamiltonian_operators

    @property
    def static_dissipators(self) -> Optional[torch.Tensor]:
        """Static dissipator stack."""
        return self._static_dissipators

    @property
    def dissipator_operators(self) -> Optional[torch.Tensor]:
        """Dissipator operator stack."""
        return self._dissipator_operators

    def evaluate_hamiltonian(self, ham_coefficients) -> torch.Tensor:
        r"""Return ``H_d + Sigma_j s_j H_j`` (not vectorized)."""
        if self._hamiltonian_operators is not None:
            coeffs = to_tensor(ham_coefficients).to(
                device=self._hamiltonian_operators.device, dtype=self._hamiltonian_operators.dtype
            )
            combo = torch.tensordot(coeffs, self._hamiltonian_operators, dims=1)
            if self._static_hamiltonian is not None:
                return combo + self._static_hamiltonian
            return combo
        if self._static_hamiltonian is not None:
            return self._static_hamiltonian
        raise DynamicsError(
            f"{type(self).__name__} with None for both static_hamiltonian and "
            "hamiltonian_operators cannot evaluate Hamiltonian."
        )

    def _concatenate_coefficients(self, ham_coefficients, dis_coefficients):
        if self._hamiltonian_operators is not None and self._dissipator_operators is not None:
            return torch.cat(
                [torch.atleast_1d(to_tensor(ham_coefficients)),
                 torch.atleast_1d(to_tensor(dis_coefficients))],
                dim=-1,
            )
        if self._hamiltonian_operators is not None:
            return ham_coefficients
        if self._dissipator_operators is not None:
            return dis_coefficients
        return None

    def evaluate(self, ham_coefficients, dis_coefficients) -> torch.Tensor:
        """Return the ``(n^2, n^2)`` vectorized generator."""
        coeffs = self._concatenate_coefficients(ham_coefficients, dis_coefficients)
        return self._operator_collection.evaluate(coeffs)

    def evaluate_rhs(self, ham_coefficients, dis_coefficients, y) -> torch.Tensor:
        """Apply the vectorized generator to a column-stacked state."""
        coeffs = self._concatenate_coefficients(ham_coefficients, dis_coefficients)
        return self._operator_collection.evaluate_rhs(coeffs, y)

    def __call__(self, ham_coefficients, dis_coefficients, y=None) -> torch.Tensor:
        if y is None:
            return self.evaluate(ham_coefficients, dis_coefficients)
        return self.evaluate_rhs(ham_coefficients, dis_coefficients, y)
