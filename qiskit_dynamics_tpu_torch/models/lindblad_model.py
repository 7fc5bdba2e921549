"""Lindblad master-equation model (dense, vectorized).

Counterpart of ``qiskit_dynamics_tpu/models/lindblad_model.py``. Holds four
operator groups (static and time-dependent Hamiltonian and dissipator terms)
with two signal lists; all operators are rotated into the frame eigenbasis at
construction and held as tensors on the model's ``device`` in its ``dtype``.
The column-stacking ``vectorized`` mode, where the whole right-hand side is
one ``(n^2, n^2) @ (n^2,)`` product, is ported; the non-vectorized
``LindbladCollection`` waits for ROADMAP A12.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..dtypes import complex_dtype
from ..exceptions import DynamicsError
from ..signals import Signal, SignalList
from ..unified import to_numpy
from .generator_model import (
    BaseGeneratorModel,
    _operators_into_frame_basis,
    _static_operator_into_frame_basis,
    is_hermitian,
)
from .operator_collections import VectorizedLindbladCollection
from .rotating_frame import RotatingFrame

__all__ = ["LindbladModel"]


def _stack(operators):
    """A list or array of operators as one host array, or None."""
    if operators is None:
        return None
    return np.stack([to_numpy(op) for op in operators])


class LindbladModel(BaseGeneratorModel):
    r"""Lindblad equation

    ``d rho/dt = -i[H(t), rho] + Sigma_j (N_j rho N_j^dag - 1/2 {N_j^dag N_j, rho})
    + Sigma_j gamma_j(t) (L_j rho L_j^dag - 1/2 {L_j^dag L_j, rho})``,

    evaluated on column-stacked density matrices (``vectorized=True``).
    ``device=None`` is the CUDA device; pass ``device="cpu"`` for the host.
    """

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        hamiltonian_signals: Optional[Union[List[Signal], SignalList]] = None,
        static_dissipators=None,
        dissipator_operators=None,
        dissipator_signals: Optional[Union[List[Signal], SignalList]] = None,
        rotating_frame: Optional[Union[RotatingFrame, np.ndarray]] = None,
        in_frame_basis: bool = False,
        vectorized: bool = False,
        validate: bool = True,
        device=None,
        dtype: torch.dtype = torch.complex128,
    ):
        if not vectorized:
            raise NotImplementedError(
                "LindbladModel(vectorized=False) needs the non-vectorized LindbladCollection, "
                "which waits for ROADMAP A12; pass vectorized=True."
            )
        if (
            static_hamiltonian is None
            and hamiltonian_operators is None
            and static_dissipators is None
            and dissipator_operators is None
        ):
            raise DynamicsError(
                f"{type(self).__name__} requires at least one operator group: pass "
                "static_hamiltonian, hamiltonian_operators, static_dissipators, "
                "or dissipator_operators."
            )
        hamiltonian_operators = _stack(hamiltonian_operators)
        if static_hamiltonian is not None:
            static_hamiltonian = to_numpy(static_hamiltonian)
        if validate:
            if static_hamiltonian is not None and not is_hermitian(static_hamiltonian):
                raise DynamicsError("LindbladModel static_hamiltonian must be Hermitian.")
            if hamiltonian_operators is not None and any(
                not is_hermitian(op) for op in hamiltonian_operators
            ):
                raise DynamicsError("LindbladModel hamiltonian_operators must be Hermitian.")

        self._vectorized = vectorized
        self._rotating_frame = RotatingFrame(
            rotating_frame, device=device, dtype=complex_dtype(dtype)
        )
        self._in_frame_basis = in_frame_basis

        frame = self._rotating_frame
        if static_hamiltonian is not None:
            static_hamiltonian = -1j * static_hamiltonian
        static_hamiltonian = _static_operator_into_frame_basis(static_hamiltonian, frame)
        if static_hamiltonian is not None:
            static_hamiltonian = 1j * static_hamiltonian

        self._operator_collection = VectorizedLindbladCollection(
            static_hamiltonian=static_hamiltonian,
            hamiltonian_operators=_operators_into_frame_basis(hamiltonian_operators, frame),
            static_dissipators=_operators_into_frame_basis(_stack(static_dissipators), frame),
            dissipator_operators=_operators_into_frame_basis(_stack(dissipator_operators), frame),
        )
        self._hamiltonian_signals = None
        self._dissipator_signals = None
        self.signals = (hamiltonian_signals, dissipator_signals)

    # --- properties ----------------------------------------------------------
    @property
    def dim(self) -> int:
        oc = self._operator_collection
        for ops in (oc.static_hamiltonian, oc.hamiltonian_operators, oc.static_dissipators,
                    oc.dissipator_operators):
            if ops is not None:
                return ops.shape[-1]
        raise DynamicsError("LindbladModel has no operators.")

    @property
    def vectorized(self) -> bool:
        """Whether the model evaluates in column-stacked vectorized form."""
        return self._vectorized

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

    def _in_chosen_basis(self, ops):
        if ops is None or self._in_frame_basis:
            return ops
        return self._rotating_frame.operator_out_of_frame_basis(ops)

    @property
    def static_hamiltonian(self) -> Optional[torch.Tensor]:
        """Static Hamiltonian term."""
        return self._in_chosen_basis(self._operator_collection.static_hamiltonian)

    @property
    def hamiltonian_operators(self) -> Optional[torch.Tensor]:
        """Hamiltonian operator stack."""
        return self._in_chosen_basis(self._operator_collection.hamiltonian_operators)

    @property
    def static_dissipators(self) -> Optional[torch.Tensor]:
        """Static dissipator stack."""
        return self._in_chosen_basis(self._operator_collection.static_dissipators)

    @property
    def dissipator_operators(self) -> Optional[torch.Tensor]:
        """Dissipator operator stack."""
        return self._in_chosen_basis(self._operator_collection.dissipator_operators)

    @property
    def signals(self) -> Tuple[Optional[SignalList], Optional[SignalList]]:
        """Tuple of (hamiltonian signals, dissipator signals)."""
        return (self._hamiltonian_signals, self._dissipator_signals)

    @signals.setter
    def signals(self, new_signals):
        hamiltonian_signals, dissipator_signals = new_signals
        self._hamiltonian_signals = self._checked_signals(
            hamiltonian_signals, self._operator_collection.hamiltonian_operators, "Hamiltonian"
        )
        self._dissipator_signals = self._checked_signals(
            dissipator_signals, self._operator_collection.dissipator_operators, "Dissipator"
        )

    @staticmethod
    def _checked_signals(signals, operators, kind: str) -> Optional[SignalList]:
        if signals is None:
            return None
        if operators is None:
            raise DynamicsError(f"{kind} signals must be None if {kind.lower()} operators is None.")
        if isinstance(signals, (list, tuple)):
            signals = SignalList(list(signals))
        if not isinstance(signals, SignalList):
            raise DynamicsError(f"{kind} signals specified in unaccepted format.")
        if len(signals) != operators.shape[0]:
            raise DynamicsError(
                f"{kind} signals need to have the same length as {kind.lower()} operators."
            )
        return signals

    # --- evaluation --------------------------------------------------------
    def _signal_values(self, time):
        oc = self._operator_collection
        ham = dis = None
        if self._hamiltonian_signals is not None:
            ham = self._hamiltonian_signals(time)
        elif oc.hamiltonian_operators is not None:
            raise DynamicsError(
                f"{type(self).__name__} with non-empty hamiltonian operators cannot be "
                "evaluated without hamiltonian signals."
            )
        if self._dissipator_signals is not None:
            dis = self._dissipator_signals(time)
        elif oc.dissipator_operators is not None:
            raise DynamicsError(
                f"{type(self).__name__} with non-empty dissipator operators cannot be "
                "evaluated without dissipator signals."
            )
        return ham, dis

    def evaluate_hamiltonian(self, time) -> torch.Tensor:
        """The Hamiltonian matrix at a time (frame-transformed, not vectorized)."""
        ham_sig_vals, _ = self._signal_values(time)
        ham = self._operator_collection.evaluate_hamiltonian(ham_sig_vals)
        return self._rotating_frame.operator_into_frame(
            time, ham, operator_in_frame_basis=True, return_in_frame_basis=self._in_frame_basis
        )

    def evaluate(self, time) -> torch.Tensor:
        """The ``(n^2, n^2)`` vectorized generator at a time."""
        out = self._operator_collection.evaluate(*self._signal_values(time))
        return self._rotating_frame.vectorized_map_into_frame(
            time, out, operator_in_frame_basis=True, return_in_frame_basis=self._in_frame_basis
        )

    def evaluate_rhs(self, time, y) -> torch.Tensor:
        """The Lindblad right-hand side on a column-stacked state ``(n^2,)``
        or a stack of them ``(n^2, m)``."""
        ham_sig_vals, dis_sig_vals = self._signal_values(time)
        frame = self._rotating_frame
        if frame.frame_diag is None:
            return self._operator_collection.evaluate_rhs(ham_sig_vals, dis_sig_vals, frame._tensor(y))
        rhs = frame.operator_out_of_frame(
            time, y, operator_in_frame_basis=self._in_frame_basis,
            return_in_frame_basis=True, vectorized_operators=True,
        )
        rhs = self._operator_collection.evaluate_rhs(ham_sig_vals, dis_sig_vals, rhs)
        return frame.operator_into_frame(
            time, rhs, operator_in_frame_basis=True,
            return_in_frame_basis=self._in_frame_basis, vectorized_operators=True,
        )
