"""``solve_ode`` / ``solve_lmde``: the functional solver interface.

Counterpart of ``qiskit_dynamics_tpu/solvers/solver_functions.py``. Method
table:

ODE methods (``dy/dt = f(t, y)``):

- scipy (host, float64): ``RK45, RK23, BDF, DOP853, Radau, LSODA`` or an
  ``OdeSolver`` subclass;
- fixed-step: ``RK4`` (host), ``jax_RK4`` (device);
- adaptive on the device: ``tpu_dopri5`` / ``tpu_dop853`` (``jax_dopri5`` /
  ``jax_dop853`` are accepted aliases), an eager loop with one host read per
  step (:mod:`.adaptive`).

LMDE methods (``dy/dt = G(t) y``):

- ``scipy_expm`` (host), ``jax_expm`` (device; fixed-step Magnus 1/2/3
  exponential, ``expm_method="pade"`` or ``"taylor"``);
- ``lanczos_diag`` (host), ``jax_lanczos_diag`` (device), Krylov expm action;
- ``jax_expm_parallel``, ``jax_RK4_parallel`` (device; per-step propagators
  composed by a log-depth scan).

The device methods run on the device of ``y0`` when it is a tensor, else on
the model's device, else on the CUDA device; their results stay there as
tensors. The host methods return numpy.

Not ported: ``tensor_expm`` (the Hilbert-space-sharded solve, ROADMAP A13)
raises; ``jax_odeint`` and the diffrax methods are bridges to JAX libraries
with no PyTorch counterpart installed, and raise. The JAX package's guard
against scipy-sparse models under a trace waits for the sparse collections
(ROADMAP A12): every model of the port is dense.

Models (Hamiltonian/generator models and vectorized Lindblad models) are
flipped into the frame eigenbasis for solving and the results rotated back
(the frame-basis fast path).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union
from warnings import warn

import numpy as np
import torch
from scipy.integrate import OdeSolver

from ..dtypes import complex_dtype
from ..exceptions import DynamicsError
from ..models import BaseGeneratorModel, GeneratorModel, HamiltonianModel, LindbladModel
from ..unified import default_device, is_tensor, to_numpy, to_tensor
from ..utils.metrics import solve_span
from .adaptive import tpu_dop853, tpu_dopri5
from .fixed_step_solvers import (
    RK4_solver,
    jax_expm_parallel_solver,
    jax_expm_solver,
    jax_lanczos_diag_solver,
    jax_RK4_parallel_solver,
    jax_RK4_solver,
    lanczos_diag_solver,
    scipy_expm_solver,
)
from .results import OdeResult
from .scipy_solve_ivp import scipy_solve_ivp, SOLVE_IVP_METHODS
from .solver_utils import is_lindblad_model_not_vectorized, is_lindblad_model_vectorized

__all__ = ["solve_ode", "solve_lmde", "ODE_METHODS", "LMDE_METHODS"]

_TPU_ADAPTIVE = {
    "tpu_dopri5": tpu_dopri5,
    "jax_dopri5": tpu_dopri5,
    "tpu_dop853": tpu_dop853,
    "jax_dop853": tpu_dop853,
}

ODE_METHODS = (
    ["RK45", "RK23", "BDF", "DOP853", "Radau", "LSODA"]
    + ["RK4"]
    + ["jax_odeint", "jax_RK4"]
    + list(_TPU_ADAPTIVE)
)
LMDE_METHODS = [
    "scipy_expm",
    "lanczos_diag",
    "jax_lanczos_diag",
    "jax_expm",
    "jax_expm_parallel",
    "jax_RK4_parallel",
    "tensor_expm",
]

_DEVICE_METHODS = (
    ["jax_RK4", "jax_expm", "jax_expm_parallel", "jax_RK4_parallel", "jax_lanczos_diag"]
    + list(_TPU_ADAPTIVE)
)


def _is_scipy_method(method) -> bool:
    return method in SOLVE_IVP_METHODS or (
        isinstance(method, type) and issubclass(method, OdeSolver)
    )


def _is_device_method(method) -> bool:
    """Whether the method runs on tensors on a device (the JAX package's
    ``_is_jax_method`` less the JAX-library bridges)."""
    return method in _DEVICE_METHODS


def _is_diffrax_method(method) -> bool:
    """Whether ``method`` is a diffrax solver instance (duck-typed, as in the
    JAX package)."""
    return type(method).__module__.split(".")[0] == "diffrax"


def _refuse_unported(method):
    if method == "jax_odeint" or _is_diffrax_method(method):
        raise DynamicsError(
            f"method {method!r} is not ported: jax_odeint and the diffrax methods bridge to JAX "
            "libraries with no PyTorch counterpart installed (ROADMAP A12)."
        )


def _device_y0(y0, rhs, complex_state: bool = True) -> torch.Tensor:
    """``y0`` as a tensor for a device method: on its own device when it is a
    tensor, else on the model's device, else on the CUDA device; complex
    unless ``complex_state`` is False (``jax_RK4`` keeps a real state real,
    as in the JAX package)."""
    if is_tensor(y0):
        y = y0
    elif isinstance(rhs, BaseGeneratorModel):
        y = to_tensor(y0, device=rhs.rotating_frame.device)
    else:
        y = to_tensor(y0, device=default_device())
    return y.to(complex_dtype(y.dtype)) if complex_state and not y.is_complex() else y


def _lanczos_validation(rhs, t_span, y0, k_dim):
    if isinstance(rhs, BaseGeneratorModel):
        if not isinstance(rhs, HamiltonianModel):
            raise DynamicsError(
                "Lanczos solvers can only be used for HamiltonianModel or function-based "
                "anti-Hermitian generators."
            )
        # every model of the port is dense (the sparse collections are ROADMAP A12)
        warn(
            "lanczos_diag should be used with a generator in sparse mode for better "
            "performance.",
            stacklevel=2,
        )
        dim = rhs.dim
    else:
        dim = np.shape(to_numpy(rhs(np.asarray(t_span)[0])))[0]
    if k_dim > dim:
        raise DynamicsError("k_dim can be no larger than the dimension of the generator.")
    if np.ndim(to_numpy(y0)) not in (1, 2):
        raise DynamicsError("y0 must be 1d or 2d.")


def solve_ode(
    rhs: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = f(t, y)``. See the module docstring for the methods."""
    _refuse_unported(method)
    if method not in ODE_METHODS and not _is_scipy_method(method):
        raise DynamicsError(f"Method {method} not supported by solve_ode.")

    if isinstance(rhs, BaseGeneratorModel):
        _, solver_rhs, y0, model_in_frame_basis = setup_generator_model_rhs_y0_in_frame_basis(
            rhs, y0
        )
    else:
        solver_rhs = rhs
    y0_ndim = len(tuple(y0.shape)) if is_tensor(y0) else np.ndim(y0)

    try:
        with solve_span(f"solve_ode[{method}]", method=str(method)):
            if _is_scipy_method(method):
                results = scipy_solve_ivp(solver_rhs, t_span, y0, method, t_eval=t_eval, **kwargs)
            elif method == "RK4":
                results = RK4_solver(solver_rhs, t_span, y0, t_eval=t_eval, **kwargs)
            elif method == "jax_RK4":
                results = jax_RK4_solver(
                    solver_rhs, t_span, _device_y0(y0, rhs, complex_state=False), t_eval=t_eval,
                    **kwargs,
                )
            else:
                results = _TPU_ADAPTIVE[method](
                    solver_rhs, t_span, _device_y0(y0, rhs), t_eval=t_eval, **kwargs
                )
    finally:
        if isinstance(rhs, BaseGeneratorModel):
            rhs.in_frame_basis = model_in_frame_basis

    if isinstance(rhs, BaseGeneratorModel) and not model_in_frame_basis:
        results.y = results_y_out_of_frame_basis(rhs, results.y, y0_ndim)
    return results


def solve_lmde(
    generator: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = G(t) y``. See the module docstring for the methods."""
    if method in ODE_METHODS or _is_scipy_method(method) or _is_diffrax_method(method):
        if isinstance(generator, BaseGeneratorModel):
            rhs = generator
        else:
            def rhs(t, y):
                return generator(t) @ y

        return solve_ode(rhs, t_span, y0, method=method, t_eval=t_eval, **kwargs)

    if method not in LMDE_METHODS:
        raise DynamicsError(f"Method {method} not supported by solve_lmde.")
    if method == "tensor_expm":
        raise DynamicsError(
            'method "tensor_expm" (the Hilbert-space-sharded solve) is not ported yet '
            "(ROADMAP A13)."
        )
    if is_lindblad_model_not_vectorized(generator):
        raise DynamicsError(
            "LMDE-specific methods with LindbladModel requires setting vectorized=True."
        )

    if isinstance(generator, BaseGeneratorModel):
        solver_generator, _, y0, model_in_frame_basis = (
            setup_generator_model_rhs_y0_in_frame_basis(generator, y0)
        )
    else:
        solver_generator = generator
    y0_ndim = len(tuple(y0.shape)) if is_tensor(y0) else np.ndim(y0)

    try:
        with solve_span(f"solve_lmde[{method}]", method=str(method)):
            if method == "scipy_expm":
                results = scipy_expm_solver(solver_generator, t_span, y0, t_eval=t_eval, **kwargs)
            elif method == "lanczos_diag":
                _lanczos_validation(generator, t_span, y0, kwargs["k_dim"])
                results = lanczos_diag_solver(
                    solver_generator, t_span, to_numpy(y0), t_eval=t_eval, **kwargs
                )
            else:
                device_solver = {
                    "jax_lanczos_diag": jax_lanczos_diag_solver,
                    "jax_expm": jax_expm_solver,
                    "jax_expm_parallel": jax_expm_parallel_solver,
                    "jax_RK4_parallel": jax_RK4_parallel_solver,
                }[method]
                if method == "jax_lanczos_diag":
                    _lanczos_validation(generator, t_span, y0, kwargs["k_dim"])
                results = device_solver(
                    solver_generator, t_span, _device_y0(y0, generator), t_eval=t_eval, **kwargs
                )
    finally:
        if isinstance(generator, BaseGeneratorModel):
            generator.in_frame_basis = model_in_frame_basis

    if isinstance(generator, BaseGeneratorModel) and not model_in_frame_basis:
        results.y = results_y_out_of_frame_basis(generator, results.y, y0_ndim)
    return results


def setup_generator_model_rhs_y0_in_frame_basis(
    generator_model: BaseGeneratorModel, y0
) -> Tuple[Callable, Callable, torch.Tensor, bool]:
    """Flip a model into the frame eigenbasis and transform y0 accordingly.

    Returns ``(generator, rhs, y0_in_frame_basis, was_in_frame_basis)``.
    Mutates ``generator_model.in_frame_basis`` (restored by the caller).
    """
    model_in_frame_basis = generator_model.in_frame_basis
    frame = generator_model.rotating_frame
    if not model_in_frame_basis:
        if is_lindblad_model_vectorized(generator_model):
            y0 = frame._tensor(y0)
            if frame.frame_basis is not None:
                y0 = frame.vectorized_frame_basis_adjoint @ y0
        elif isinstance(generator_model, GeneratorModel):
            y0 = frame.state_into_frame_basis(y0)
    generator_model.in_frame_basis = True

    def generator(t):
        return generator_model(t)

    def rhs(t, y):
        return generator_model(t, y)

    return generator, rhs, y0, model_in_frame_basis


def results_y_out_of_frame_basis(generator_model, results_y, y0_ndim: int):
    """Rotate a time-stacked result (host numpy or a device tensor) out of the
    frame basis."""
    frame = generator_model.rotating_frame
    if frame.frame_basis is None:
        return results_y
    if isinstance(generator_model, LindbladModel):
        basis = frame.vectorized_frame_basis
    else:
        basis = frame.frame_basis
    if is_tensor(results_y):
        basis = basis.to(device=results_y.device, dtype=results_y.dtype)
    else:
        basis = basis.cpu().numpy()
    if y0_ndim == 1:
        return results_y @ basis.T
    return basis @ results_y
