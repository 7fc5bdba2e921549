"""Hamiltonian model: Schrodinger-equation generator ``G(t) = -i H(t)``.

Counterpart of ``qiskit_dynamics_tpu/models/hamiltonian_model.py``. Stores
``-i H`` internally (so all generator machinery applies unchanged); the
public ``static_operator`` / ``operators`` properties undo the ``-i``.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..signals import Signal, SignalList
from ..unified import to_numpy
from .rotating_frame import RotatingFrame
from .generator_model import GeneratorModel, is_hermitian

__all__ = ["HamiltonianModel", "is_hermitian"]


class HamiltonianModel(GeneratorModel):
    r"""Model for ``H(t) = H_d + Sigma_j s_j(t) H_j`` with Hermitian operators.

    Evaluation methods return the generator ``-i H`` form, i.e.
    ``evaluate(t)`` is anti-Hermitian.
    """

    def __init__(
        self,
        static_operator=None,
        operators=None,
        signals: Optional[Union[SignalList, List[Signal]]] = None,
        rotating_frame: Optional[Union[RotatingFrame, np.ndarray]] = None,
        in_frame_basis: bool = False,
        validate: bool = True,
        device=None,
        dtype: torch.dtype = torch.complex128,
    ):
        if static_operator is not None:
            static_operator = to_numpy(static_operator)
            if validate and not is_hermitian(static_operator):
                raise DynamicsError("HamiltonianModel static_operator must be Hermitian.")
            static_operator = -1j * static_operator
        if operators is not None:
            operators = np.stack([to_numpy(op) for op in operators])
            if validate and any(not is_hermitian(op) for op in operators):
                raise DynamicsError("HamiltonianModel operators must be Hermitian.")
            operators = -1j * operators

        super().__init__(
            static_operator=static_operator,
            operators=operators,
            signals=signals,
            rotating_frame=rotating_frame,
            in_frame_basis=in_frame_basis,
            device=device,
            dtype=dtype,
        )

    @property
    def static_operator(self) -> Optional[torch.Tensor]:
        """The static Hamiltonian (Hermitian form)."""
        if self._operator_collection.static_operator is None:
            return None
        if self.in_frame_basis:
            return self._operator_collection.static_operator
        return 1j * self.rotating_frame.operator_out_of_frame_basis(
            self._operator_collection.static_operator
        )

    @property
    def operators(self) -> Optional[torch.Tensor]:
        """The Hamiltonian operators (Hermitian form)."""
        if self._operator_collection.operators is None:
            return None
        if self.in_frame_basis:
            return 1j * self._operator_collection.operators
        return 1j * self.rotating_frame.operator_out_of_frame_basis(
            self._operator_collection.operators
        )
