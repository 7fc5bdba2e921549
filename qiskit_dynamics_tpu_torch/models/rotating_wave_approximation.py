"""Rotating-wave approximation (RWA).

Counterpart of ``qiskit_dynamics_tpu/models/rotating_wave_approximation.py``.
Masks operator entries whose effective frequency (carrier +/- frame
frequency difference) exceeds the cutoff, producing a model with 2k
operators ``(G_i^+ + G_i^-)/2`` and ``i(G_i^+ - G_i^-)/2`` driven by the
original signals and phase-shifted (-pi/2) copies.

Construction is host-side numpy (frame frequencies, masks); the returned
model holds tensors on the input model's device. Generator and Hamiltonian
models only: the Lindblad branch is still to be ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..signals import Signal, SignalSum, SignalList
from ..unified import to_numpy
from .generator_model import GeneratorModel
from .hamiltonian_model import HamiltonianModel

__all__ = ["rotating_wave_approximation", "get_rwa_operators", "get_rwa_signals"]


def rotating_wave_approximation(
    model: GeneratorModel, cutoff_freq: float, return_signal_map: bool = False
):
    """Apply the RWA to a model, returning a model with 2x the operators.

    If ``return_signal_map`` is True, also return the function mapping pre-RWA
    signals to post-RWA signals (needed to update signals on the RWA model).
    """
    if not isinstance(model, GeneratorModel):
        raise TypeError("rotating_wave_approximation got an unsupported model type.")
    n = model.dim
    frame = model.rotating_frame

    if frame.frame_diag is None:
        frame_freqs = np.zeros((n, n))
        frame_shift = np.zeros((n, n), dtype=complex)
    else:
        diag = to_numpy(frame.frame_diag)
        # effective frequency nu_jk = Im[-d_j + d_k] / 2pi
        frame_freqs = (diag[None, :] - diag[:, None]).imag / (2 * np.pi)
        frame_shift = np.diag(diag)
        if isinstance(model, HamiltonianModel):
            frame_shift = 1j * frame_shift

    low_pass = (np.abs(frame_freqs) < cutoff_freq).astype(float)

    if model.signals is None and model.operators is not None:
        raise ValueError("Model must have nontrivial signals to perform the RWA.")

    cur_drift = model._operator_collection.static_operator
    rwa_drift = None
    if cur_drift is not None:
        cur_drift = to_numpy(cur_drift)
        if isinstance(model, HamiltonianModel):
            cur_drift = 1j * cur_drift
        rwa_drift = frame.operator_out_of_frame_basis((cur_drift + frame_shift) * low_pass)

    operators = model._operator_collection.operators
    if operators is not None:
        operators = to_numpy(operators)
        if isinstance(model, HamiltonianModel):
            operators = 1j * operators

    rwa_operators = get_rwa_operators(operators, model.signals, frame, frame_freqs, cutoff_freq)
    rwa_model = model.__class__(
        static_operator=rwa_drift,
        operators=rwa_operators,
        signals=get_rwa_signals(model.signals),
        rotating_frame=frame,
        in_frame_basis=model.in_frame_basis,
        device=model.device,
        dtype=model.dtype,
    )
    if return_signal_map:
        return rwa_model, get_rwa_signals
    return rwa_model


def get_rwa_operators(current_ops, current_sigs: SignalList, rotating_frame, frame_freqs,
                      cutoff_freq: float):
    """Mask an operator stack into the post-RWA ``(2k, n, n)`` stack."""
    if current_ops is None:
        return None
    current_ops = to_numpy(current_ops)

    current_sigs = current_sigs.flatten()
    carrier_freqs = np.array(
        [float(sig_sum.components[0].carrier_freq)
         if not isinstance(sig_sum, SignalSum) or len(sig_sum) > 0
         else 0.0
         for sig_sum in current_sigs.components]
    )

    k = len(carrier_freqs)
    n = current_ops.shape[-1]
    frame_freqs = np.broadcast_to(frame_freqs, (k, n, n))
    carrier_freqs = carrier_freqs.reshape((k, 1, 1))

    pos_terms = current_ops * (np.abs(carrier_freqs + frame_freqs) < cutoff_freq).astype(float)
    neg_terms = current_ops * (np.abs(-carrier_freqs + frame_freqs) < cutoff_freq).astype(float)

    real_component = pos_terms / 2 + neg_terms / 2
    imag_component = 1j * pos_terms / 2 - 1j * neg_terms / 2

    return rotating_frame.operator_out_of_frame_basis(
        np.concatenate([real_component, imag_component], axis=0)
    )


def get_rwa_signals(curr_signal_list) -> Optional[SignalList]:
    """Map pre-RWA signals to post-RWA signals (originals + phase -pi/2 copies)."""
    if curr_signal_list is None:
        return None
    if not isinstance(curr_signal_list, SignalList):
        curr_signal_list = SignalList(curr_signal_list)
    curr_signal_list = curr_signal_list.flatten()

    real_components = []
    imag_components = []
    for sig_sum in curr_signal_list.components:
        sig = sig_sum.components[0] if isinstance(sig_sum, SignalSum) else sig_sum
        real_components.append(sig)
        imag_components.append(
            SignalSum(Signal(sig._envelope, sig.carrier_freq, sig.phase - np.pi / 2))
        )
    return SignalList(real_components + imag_components)
