"""Operator collections: the RHS math (dense).

Counterpart of the dense ``OperatorCollection`` in
``qiskit_dynamics_tpu/models/operator_collections.py``. The sparse and
Lindblad collections are still to be ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..exceptions import DynamicsError
from ..unified import to_tensor

__all__ = ["OperatorCollection"]


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
