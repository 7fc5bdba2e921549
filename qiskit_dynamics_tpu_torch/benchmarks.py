"""Benchmark models (counterpart of ``qiskit_dynamics_tpu/benchmarks.py``).

``cr_solver`` is the headline model: a two-transmon cross-resonance
``Solver`` (dim 16 at the default 4 levels per transmon) with a rotating
frame equal to diag(H0) and the RWA at the mean transmon frequency, the
model of the 10,000-point amplitude sweep. The JAX package's other benchmark
models are still to be ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .solvers import Solver

__all__ = ["cr_solver"]


def _transmon_ops(dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    a = np.diag(np.sqrt(np.arange(1, dim)), 1)
    adag = a.conj().T
    N = np.diag(np.arange(dim))
    return a, adag, N


def cr_solver(
    dim: int = 4,
    w0: float = 5.0,
    w1: float = 5.1,
    alpha0: float = -0.33,
    alpha1: float = -0.33,
    J: float = 0.002,
    rwa_cutoff_freq: Optional[float] = None,
    device=None,
    dtype: torch.dtype = torch.complex128,
):
    """Two-transmon cross-resonance Solver (drive on qubit 0 at qubit 1's freq).

    ``dim`` levels per transmon (total Hilbert dim ``dim**2``; dim=4 -> 16).
    Rotating frame = diagonal of the static Hamiltonian; the RWA cutoff
    defaults to the mean transmon frequency. ``device``/``dtype`` place the
    model's operators.

    Returns:
        (solver, drive_freq): the configured ``Solver`` and the CR drive
        carrier frequency (= target-qubit frequency).
    """
    a, adag, N = _transmon_ops(dim)
    ident = np.eye(dim)

    def two(op, which):
        return np.kron(op, ident) if which == 0 else np.kron(ident, op)

    H0 = (
        2 * np.pi * w0 * two(N, 0)
        + np.pi * alpha0 * two(N @ (N - ident), 0)
        + 2 * np.pi * w1 * two(N, 1)
        + np.pi * alpha1 * two(N @ (N - ident), 1)
        + 2 * np.pi * J * (np.kron(adag, a) + np.kron(a, adag))
    )
    drive0 = 2 * np.pi * two(a + adag, 0)

    if rwa_cutoff_freq is None:
        # mean transmon frequency: keeps the ~|w0-w1| rotating terms, drops the
        # ~(w0+w1) counter-rotating ones with a wide margin on both sides
        rwa_cutoff_freq = (w0 + w1) / 2

    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[drive0],
        rotating_frame=np.diag(H0),
        rwa_cutoff_freq=rwa_cutoff_freq,
        rwa_carrier_freqs=[w1],
        device=device,
        dtype=dtype,
    )
    return solver, w1
