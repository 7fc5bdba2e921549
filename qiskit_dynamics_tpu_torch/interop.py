"""Carry a JAX-package model across to the port.

The JAX package's models are built from host arrays (its "weights"): a
static operator, an operator stack, dissipators, a frame operator, the
``in_frame_basis`` flag and, for a ``Solver``, the RWA cutoff and carriers.
These functions take those arrays as numpy and return the port's
``HamiltonianModel``/``LindbladModel``/``Solver`` computing the same thing,
on ``device`` (``None``: the CUDA device). They accept numpy only, so this module never
touches ``jax``: convert a JAX array with ``numpy.asarray`` first.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .models import HamiltonianModel, LindbladModel
from .models.rotating_frame import _enforce_anti_herm
from .perturbation import ArrayPolynomial
from .solvers import DysonSolver, ExpansionModel, MagnusSolver, Solver

__all__ = [
    "hamiltonian_model_from_arrays",
    "lindblad_model_from_arrays",
    "solver_from_arrays",
    "expansion_model_from_arrays",
    "perturbative_solver_from_arrays",
]


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
    frame = _host("rotating_frame", rotating_frame)
    return HamiltonianModel(
        static_operator=_with_frame_hamiltonian(_host("static_operator", static_operator), frame),
        operators=_host("operators", operators, stack=True),
        rotating_frame=frame,
        in_frame_basis=bool(in_frame_basis),
        device=device,
        dtype=dtype,
    )


def _with_frame_hamiltonian(static_operator, frame):
    """A reported static Hamiltonian has the frame Hamiltonian subtracted;
    add it back, so the port's model subtracts it once, as the JAX model does."""
    if frame is None or static_operator is None:
        return static_operator
    frame_hamiltonian = 1j * _enforce_anti_herm(frame)  # Hermitian H_F
    if frame_hamiltonian.ndim == 1:
        frame_hamiltonian = np.diag(frame_hamiltonian)
    return static_operator + frame_hamiltonian


def lindblad_model_from_arrays(
    static_hamiltonian: Optional[np.ndarray],
    hamiltonian_operators: Optional[np.ndarray],
    static_dissipators: Optional[np.ndarray] = None,
    dissipator_operators: Optional[np.ndarray] = None,
    rotating_frame: Optional[np.ndarray] = None,
    in_frame_basis: bool = False,
    device=None,
    dtype: torch.dtype = torch.complex128,
) -> LindbladModel:
    """The port's vectorized ``LindbladModel`` for a JAX ``LindbladModel``'s
    arrays, as it reports them with ``in_frame_basis=False``
    (``static_hamiltonian``, ``hamiltonian_operators``,
    ``static_dissipators``, ``dissipator_operators``) and its
    ``rotating_frame.frame_operator``. Signals are not carried: set them on
    the returned model."""
    frame = _host("rotating_frame", rotating_frame)
    return LindbladModel(
        static_hamiltonian=_with_frame_hamiltonian(
            _host("static_hamiltonian", static_hamiltonian), frame
        ),
        hamiltonian_operators=_host("hamiltonian_operators", hamiltonian_operators, stack=True),
        static_dissipators=_host("static_dissipators", static_dissipators, stack=True),
        dissipator_operators=_host("dissipator_operators", dissipator_operators, stack=True),
        rotating_frame=frame,
        in_frame_basis=bool(in_frame_basis),
        vectorized=True,
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
    static_dissipators: Optional[np.ndarray] = None,
    dissipator_operators: Optional[np.ndarray] = None,
    vectorized: bool = False,
    device=None,
    dtype: torch.dtype = torch.complex128,
) -> Solver:
    """The port's ``Solver`` for the arrays a JAX ``Solver`` was built from
    (pre-RWA Hamiltonian terms, dissipators, frame, RWA cutoff and
    carriers)."""
    carriers = None if rwa_carrier_freqs is None else [float(f) for f in rwa_carrier_freqs]
    return Solver(
        static_hamiltonian=_host("static_hamiltonian", static_hamiltonian),
        hamiltonian_operators=_host("hamiltonian_operators", hamiltonian_operators, stack=True),
        static_dissipators=_host("static_dissipators", static_dissipators, stack=True),
        dissipator_operators=_host("dissipator_operators", dissipator_operators, stack=True),
        vectorized=vectorized,
        rotating_frame=_host("rotating_frame", rotating_frame),
        in_frame_basis=bool(in_frame_basis),
        rwa_cutoff_freq=None if rwa_cutoff_freq is None else float(rwa_cutoff_freq),
        rwa_carrier_freqs=carriers,
        device=device,
        dtype=dtype,
    )


def expansion_model_from_arrays(
    operators: np.ndarray,
    frame_operator: Optional[np.ndarray],
    dt: float,
    carrier_freqs: np.ndarray,
    chebyshev_orders: Sequence[int],
    include_imag: Sequence[bool],
    Udt: np.ndarray,
    expansion_method: str,
    poly_constant: Optional[np.ndarray],
    poly_coefficients: np.ndarray,
    poly_labels: Sequence[Sequence[int]],
    device=None,
    dtype: torch.dtype = torch.complex128,
) -> ExpansionModel:
    """The port's ``ExpansionModel`` around the precomputed expansion of a JAX
    ``ExpansionModel``, without recomputing it: its ``operators``, its
    ``rotating_frame.frame_operator``, ``dt``, the carrier frequencies,
    Chebyshev orders and ``include_imag`` it was built with, ``Udt``, and its
    ``expansion_polynomial`` (``constant_term``, ``array_coefficients``,
    ``monomial_labels``)."""
    polynomial = ArrayPolynomial(
        constant_term=_host("poly_constant", poly_constant),
        array_coefficients=_host("poly_coefficients", poly_coefficients),
        monomial_labels=[tuple(int(i) for i in label) for label in poly_labels],
    )
    return ExpansionModel.from_parts(
        expansion_method, dt, _host("Udt", Udt), _host("operators", operators, stack=True),
        _host("carrier_freqs", np.asarray(carrier_freqs)), list(chebyshev_orders),
        list(include_imag), _host("frame_operator", frame_operator), polynomial,
        device=device, dtype=dtype,
    )


def perturbative_solver_from_arrays(*args, **kwargs):
    """A ``DysonSolver`` or ``MagnusSolver`` (by ``expansion_method``) around
    :func:`expansion_model_from_arrays` of the same arguments."""
    model = expansion_model_from_arrays(*args, **kwargs)
    cls = DysonSolver if model.expansion_method == "dyson" else MagnusSolver
    return cls.from_model(model)
