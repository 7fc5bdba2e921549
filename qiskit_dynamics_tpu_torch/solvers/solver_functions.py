"""``solve_ode`` / ``solve_lmde``: the functional solver interface.

Counterpart of the scipy-method branch of
``qiskit_dynamics_tpu/solvers/solver_functions.py``: the host float64
``scipy.integrate.solve_ivp`` methods (``DOP853`` is the reference and the
baseline of the sweep kernel). The fixed-step, jax-native adaptive and
LMDE-specific methods are still to be ported (``ROADMAP.md``).

Models (Hamiltonian/generator models and vectorized Lindblad models) are
flipped into the frame eigenbasis for solving and the results rotated back
(the frame-basis fast path).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch
from scipy.integrate import OdeSolver

from ..exceptions import DynamicsError
from ..models import BaseGeneratorModel, GeneratorModel, LindbladModel
from .results import OdeResult
from .scipy_solve_ivp import scipy_solve_ivp, SOLVE_IVP_METHODS

__all__ = ["solve_ode", "solve_lmde"]


def _is_scipy_method(method) -> bool:
    return method in SOLVE_IVP_METHODS or (
        isinstance(method, type) and issubclass(method, OdeSolver)
    )


def solve_ode(
    rhs: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = f(t, y)`` with a scipy method (host, float64)."""
    if not _is_scipy_method(method):
        raise DynamicsError(f"Method {method} not supported by solve_ode.")

    if isinstance(rhs, BaseGeneratorModel):
        solver_rhs, y0, model_in_frame_basis = setup_generator_model_rhs_y0_in_frame_basis(
            rhs, y0
        )
    else:
        solver_rhs = rhs

    results = scipy_solve_ivp(solver_rhs, t_span, y0, method, t_eval=t_eval, **kwargs)

    if isinstance(rhs, BaseGeneratorModel):
        if not model_in_frame_basis:
            results.y = results_y_out_of_frame_basis(rhs, results.y, np.ndim(y0))
        rhs.in_frame_basis = model_in_frame_basis
    return results


def solve_lmde(
    generator: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = G(t) y`` with a scipy method (host, float64)."""
    if not _is_scipy_method(method):
        raise DynamicsError(
            f"Method {method} not supported by solve_lmde in the port yet; the scipy "
            f"methods {SOLVE_IVP_METHODS} are."
        )
    if isinstance(generator, BaseGeneratorModel):
        rhs = generator
    else:
        def rhs(t, y):
            return generator(t) @ y

    return solve_ode(rhs, t_span, y0, method=method, t_eval=t_eval, **kwargs)


def setup_generator_model_rhs_y0_in_frame_basis(
    generator_model: BaseGeneratorModel, y0
) -> Tuple[Callable, torch.Tensor, bool]:
    """Flip a model into the frame eigenbasis and transform y0 accordingly.

    Returns ``(rhs, y0_in_frame_basis, was_in_frame_basis)``. Mutates
    ``generator_model.in_frame_basis`` (restored by the caller).
    """
    model_in_frame_basis = generator_model.in_frame_basis
    frame = generator_model.rotating_frame
    if not model_in_frame_basis:
        if isinstance(generator_model, LindbladModel):
            y0 = frame._tensor(y0)
            if frame.frame_basis is not None:
                y0 = frame.vectorized_frame_basis_adjoint @ y0
        elif isinstance(generator_model, GeneratorModel):
            y0 = frame.state_into_frame_basis(y0)
    generator_model.in_frame_basis = True

    def rhs(t, y):
        return generator_model(t, y)

    return rhs, y0, model_in_frame_basis


def results_y_out_of_frame_basis(generator_model, results_y, y0_ndim: int):
    """Rotate a time-stacked (host) result array out of the frame basis."""
    frame = generator_model.rotating_frame
    if frame.frame_basis is None:
        return results_y
    if isinstance(generator_model, LindbladModel):
        basis = frame.vectorized_frame_basis.cpu().numpy()
    else:
        basis = frame.frame_basis.cpu().numpy()
    if y0_ndim == 1:
        return results_y @ basis.T
    return basis @ results_y
