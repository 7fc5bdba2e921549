"""Generator models: dy/dt = Lambda(t, y) with Lambda(t, y) = G(t) y.

Counterpart of ``qiskit_dynamics_tpu/models/generator_model.py``. Operators
are rotated into the frame eigenbasis ONCE at construction (with the frame
diagonal subtracted from the static term), so the per-step RHS is: signal
eval -> linear combo -> diagonal-phase frame sandwich. The operators are
tensors on the model's ``device`` in its ``dtype``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Union

import numpy as np
import torch

from ..dtypes import complex_dtype
from ..exceptions import DynamicsError
from ..signals import Signal, SignalList
from ..unified import to_numpy
from .rotating_frame import RotatingFrame
from .operator_collections import OperatorCollection

__all__ = ["BaseGeneratorModel", "GeneratorModel"]


class BaseGeneratorModel(ABC):
    r"""Interface for a linear time-dependent differential equation
    ``dy/dt = Lambda(t, y)``."""

    @property
    @abstractmethod
    def dim(self) -> int:
        """The matrix dimension."""

    @property
    @abstractmethod
    def rotating_frame(self) -> RotatingFrame:
        """The rotating frame."""

    @property
    @abstractmethod
    def in_frame_basis(self) -> bool:
        """Whether the model is evaluated in the frame eigenbasis."""

    @abstractmethod
    def evaluate(self, time) -> torch.Tensor:
        r"""Evaluate the map ``Lambda(t, .)`` if possible."""

    @abstractmethod
    def evaluate_rhs(self, time, y) -> torch.Tensor:
        r"""Evaluate ``Lambda(t, y)``."""

    def __call__(self, time, y=None) -> torch.Tensor:
        return self.evaluate(time) if y is None else self.evaluate_rhs(time, y)


class GeneratorModel(BaseGeneratorModel):
    r"""Model for ``G(t) = G_d + Sigma_j s_j(t) G_j``, optionally in a rotating frame.

    With a rotating frame ``F``, the evaluated generator is
    ``e^{-tF}(G(t) - F)e^{tF}`` and the RHS is the corresponding frame
    sandwich. ``device`` and ``dtype`` (complex) place every operator.
    """

    def __init__(
        self,
        static_operator=None,
        operators=None,
        signals: Optional[Union[SignalList, List[Signal]]] = None,
        rotating_frame: Optional[Union[RotatingFrame, np.ndarray]] = None,
        in_frame_basis: bool = False,
        device=None,
        dtype: torch.dtype = torch.complex128,
    ):
        if static_operator is None and operators is None:
            raise DynamicsError(
                f"{type(self).__name__} requires at least one of static_operator or "
                "operators to be specified at construction."
            )
        self._rotating_frame = RotatingFrame(
            rotating_frame, device=device, dtype=complex_dtype(dtype)
        )
        self._in_frame_basis = in_frame_basis

        self._operator_collection = OperatorCollection(
            static_operator=_static_operator_into_frame_basis(
                static_operator, self._rotating_frame
            ),
            operators=_operators_into_frame_basis(operators, self._rotating_frame),
        )
        self._signals = None
        self.signals = signals

    # --- properties -------------------------------------------------------
    @property
    def dim(self) -> int:
        return self._operator_collection.dim

    @property
    def device(self) -> torch.device:
        """Device holding the model's operators."""
        return self._rotating_frame.device

    @property
    def dtype(self) -> torch.dtype:
        """Complex dtype of the model's operators."""
        return self._rotating_frame.dtype

    @property
    def rotating_frame(self) -> RotatingFrame:
        return self._rotating_frame

    @property
    def in_frame_basis(self) -> bool:
        return self._in_frame_basis

    @in_frame_basis.setter
    def in_frame_basis(self, in_frame_basis: bool):
        self._in_frame_basis = in_frame_basis

    @property
    def static_operator(self) -> Optional[torch.Tensor]:
        """The static operator (in the in_frame_basis-selected basis)."""
        if self._operator_collection.static_operator is None:
            return None
        if self._in_frame_basis:
            return self._operator_collection.static_operator
        return self._rotating_frame.operator_out_of_frame_basis(
            self._operator_collection.static_operator
        )

    @property
    def operators(self) -> Optional[torch.Tensor]:
        """The model operators (in the in_frame_basis-selected basis)."""
        if self._operator_collection.operators is None:
            return None
        if self._in_frame_basis:
            return self._operator_collection.operators
        return self._rotating_frame.operator_out_of_frame_basis(
            self._operator_collection.operators
        )

    @property
    def signals(self) -> Optional[SignalList]:
        """The model signals."""
        return self._signals

    @signals.setter
    def signals(self, signals):
        if signals is None:
            self._signals = None
            return
        if self._operator_collection.operators is None:
            raise DynamicsError("Signals must be None if operators is None.")
        if isinstance(signals, (list, tuple)):
            signals = SignalList(list(signals))
        if not isinstance(signals, SignalList):
            raise DynamicsError("Signals specified in unaccepted format.")
        if len(signals) != self._operator_collection.operators.shape[0]:
            raise DynamicsError("Signals needs to have the same length as operators.")
        self._signals = signals

    # --- evaluation ---------------------------------------------------------
    def _signal_values(self, time):
        if self._signals is None:
            if self._operator_collection.operators is not None:
                raise DynamicsError(
                    f"{type(self).__name__} with non-empty operators must have signals to be "
                    "evaluated."
                )
            return None
        return self._signals(time)

    def evaluate(self, time) -> torch.Tensor:
        """Evaluate the generator matrix ``G(t)`` (frame-transformed)."""
        op_combo = self._operator_collection(self._signal_values(time))
        return self._rotating_frame.operator_into_frame(
            time, op_combo, operator_in_frame_basis=True,
            return_in_frame_basis=self._in_frame_basis,
        )

    def evaluate_rhs(self, time, y) -> torch.Tensor:
        """Evaluate ``G(t) @ y`` via the frame sandwich."""
        sig_vals = self._signal_values(time)
        out = self._rotating_frame.state_out_of_frame(
            time, y, y_in_frame_basis=self._in_frame_basis, return_in_frame_basis=True
        )
        out = self._operator_collection(sig_vals, out)
        return self._rotating_frame.state_into_frame(
            time, out, y_in_frame_basis=True, return_in_frame_basis=self._in_frame_basis
        )


def _static_operator_into_frame_basis(static_operator, rotating_frame: RotatingFrame):
    """Move the static operator into the frame basis, subtracting the frame diagonal."""
    if static_operator is None:
        if rotating_frame.frame_operator is None:
            return None
        return torch.diag(-rotating_frame.frame_diag)
    return rotating_frame.generator_into_frame(
        t=0.0, operator=static_operator, return_in_frame_basis=True
    )


def _operators_into_frame_basis(operators, rotating_frame: RotatingFrame):
    """Move an operator stack into the frame basis."""
    if operators is None:
        return None
    if isinstance(operators, (list, tuple)):
        operators = np.stack([to_numpy(op) for op in operators])
    return rotating_frame.operator_into_frame_basis(operators)


def is_hermitian(operator, tol: float = 1e-10) -> bool:
    """Whether an operator is Hermitian within tolerance."""
    operator = to_numpy(operator)
    return np.linalg.norm(operator.conj().T - operator) < tol
