"""Carry a JAX-package model across to the port.

The JAX package's models are built from host arrays (its "weights"): a
static operator, an operator stack, a frame operator, the ``in_frame_basis``
flag and, for a ``Solver``, the RWA cutoff and carriers. These functions take
those arrays as numpy and return the port's ``HamiltonianModel``/``Solver``
computing the same thing. They accept numpy only, so this module never
touches ``jax``: convert a JAX array with ``numpy.asarray`` first.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .models import HamiltonianModel
from .models.rotating_frame import _enforce_anti_herm
from .solvers import Solver

__all__ = ["hamiltonian_model_from_arrays", "solver_from_arrays"]


def _host(name: str, x, stack: bool = False):
    """Check that ``x`` is numpy (or None, or a list of numpy arrays if
    ``stack``) and return it as a numpy array."""
    if x is None:
        return None
    if stack and isinstance(x, (list, tuple)):
        return np.stack([_host(name, op) for op in x])
    if not isinstance(x, np.ndarray):
        raise TypeError(f"{name} must be a numpy array (got {type(x).__name__}).")
    return x


def hamiltonian_model_from_arrays(
    static_operator: Optional[np.ndarray],
    operators: Optional[np.ndarray],
    rotating_frame: Optional[np.ndarray] = None,
    in_frame_basis: bool = False,
    device=None,
    dtype: torch.dtype = torch.complex128,
) -> HamiltonianModel:
    """The port's ``HamiltonianModel`` for a JAX model's arrays.

    ``static_operator``/``operators`` are the Hermitian arrays a JAX
    ``HamiltonianModel`` reports with ``in_frame_basis=False`` (e.g. the
    post-RWA model of a JAX ``Solver``), and ``rotating_frame`` its
    ``rotating_frame.frame_operator``. The reported static operator has the
    frame Hamiltonian subtracted; it is added back here, so the returned
    model subtracts it once, as the JAX model does. Signals are not carried:
    set them on the returned model.
    """
    static_operator = _host("static_operator", static_operator)
    frame = _host("rotating_frame", rotating_frame)
    if frame is not None and static_operator is not None:
        frame_hamiltonian = 1j * _enforce_anti_herm(frame)  # Hermitian H_F
        if frame_hamiltonian.ndim == 1:
            frame_hamiltonian = np.diag(frame_hamiltonian)
        static_operator = static_operator + frame_hamiltonian
    return HamiltonianModel(
        static_operator=static_operator,
        operators=_host("operators", operators, stack=True),
        rotating_frame=frame,
        in_frame_basis=bool(in_frame_basis),
        device=device,
        dtype=dtype,
    )


def solver_from_arrays(
    static_hamiltonian: Optional[np.ndarray],
    hamiltonian_operators: Optional[np.ndarray],
    rotating_frame: Optional[np.ndarray] = None,
    in_frame_basis: bool = False,
    rwa_cutoff_freq: Optional[float] = None,
    rwa_carrier_freqs: Optional[Sequence[float]] = None,
    device=None,
    dtype: torch.dtype = torch.complex128,
) -> Solver:
    """The port's ``Solver`` for the arrays a JAX ``Solver`` was built from
    (pre-RWA Hamiltonian terms, frame, RWA cutoff and carriers)."""
    carriers = None if rwa_carrier_freqs is None else [float(f) for f in rwa_carrier_freqs]
    return Solver(
        static_hamiltonian=_host("static_hamiltonian", static_hamiltonian),
        hamiltonian_operators=_host("hamiltonian_operators", hamiltonian_operators, stack=True),
        rotating_frame=_host("rotating_frame", rotating_frame),
        in_frame_basis=bool(in_frame_basis),
        rwa_cutoff_freq=None if rwa_cutoff_freq is None else float(rwa_cutoff_freq),
        rwa_carrier_freqs=carriers,
        device=device,
        dtype=dtype,
    )
