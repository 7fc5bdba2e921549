"""Fixed-step solvers: RK4, matrix-exponential (Magnus 1/2/3), Lanczos, and
parallel propagator chains.

Counterpart of ``qiskit_dynamics_tpu/solvers/fixed_step_solvers.py``:

- host solvers (``RK4_solver``, ``scipy_expm_solver``,
  ``lanczos_diag_solver``): numpy loops, the right-hand side brought to the
  host at every evaluation;
- device solvers (``jax_RK4_solver``, ``jax_expm_solver``,
  ``jax_lanczos_diag_solver``): the same step rules as an eager loop on
  tensors, results left on the device (named as in the JAX package so call
  sites port unchanged);
- parallel solvers (``jax_expm_parallel_solver``,
  ``jax_RK4_parallel_solver``): every step's propagator (the Magnus
  exponents go through one batched ``expm``), composed by
  :func:`~qiskit_dynamics_tpu_torch.parallel.scan.propagator_scan` in
  ``ceil(log2 T)`` batched products.

``get_fixed_step_sizes`` and ``merge_t_args``: each interval between
consecutive times is cut into the fewest equal steps no longer than
``max_dt``. The fused fixed-step sweep uses the same rule, so its grid is the
generic solvers' grid.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from scipy.linalg import expm as scipy_expm

from ..exceptions import DynamicsError
from ..ops.expm import expm_pade, expm_taylor
from ..parallel.scan import propagator_scan
from ..unified import to_numpy
from .lanczos import jax_lanczos_expm, lanczos_expm
from .results import OdeResult
from .solver_utils import trim_t_results

__all__ = [
    "RK4_solver",
    "jax_RK4_solver",
    "scipy_expm_solver",
    "jax_expm_solver",
    "lanczos_diag_solver",
    "jax_lanczos_diag_solver",
    "jax_expm_parallel_solver",
    "jax_RK4_parallel_solver",
    "get_fixed_step_sizes",
    "get_exponential_take_step",
    "merge_t_args",
]


def _rk4_take_step(rhs_func, t, y, h):
    h2 = 0.5 * h
    t2 = t + h2
    k1 = rhs_func(t, y)
    k2 = rhs_func(t2, y + h2 * k1)
    k3 = rhs_func(t2, y + h2 * k2)
    k4 = rhs_func(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _on_host(func):
    """``func`` with its result brought to the host as numpy."""
    return lambda *args: to_numpy(func(*args))


def _on_device(func, y0: torch.Tensor):
    """``func`` with its result as a tensor on ``y0``'s device, in ``y0``'s
    dtype (a model's evaluations already are; a user callable may return
    numpy)."""
    return lambda *args: torch.as_tensor(func(*args), device=y0.device).to(y0.dtype)


def RK4_solver(rhs, t_span, y0, max_dt, t_eval=None):
    """Fixed-step 4th-order Runge-Kutta (host loop)."""
    return fixed_step_solver_template(
        _rk4_take_step, rhs_func=_on_host(rhs), t_span=t_span, y0=y0, max_dt=max_dt,
        t_eval=t_eval,
    )


def jax_RK4_solver(rhs, t_span, y0, max_dt, t_eval=None):
    """Fixed-step RK4 on the device of ``y0`` (a tensor)."""
    return fixed_step_solver_template_jax(
        _rk4_take_step, rhs_func=_on_device(rhs, y0), t_span=t_span, y0=y0, max_dt=max_dt,
        t_eval=t_eval,
    )


def scipy_expm_solver(generator, t_span, y0, max_dt, t_eval=None, magnus_order: int = 1):
    """Fixed-step matrix-exponential solver via ``scipy.linalg.expm`` (host)."""
    take_step = get_exponential_take_step(magnus_order, expm_func=scipy_expm)
    return fixed_step_solver_template(
        take_step, rhs_func=_on_host(generator), t_span=t_span, y0=y0, max_dt=max_dt,
        t_eval=t_eval,
    )


def _select_expm(expm_method: str, expm_order: int, expm_squarings: int):
    """The expm: 'pade' is the norm-adaptive Pade scaling and squaring of
    :func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_pade` (the algorithm of
    ``jax.scipy.linalg.expm``), 'taylor' the branch-free fixed-order scaling
    and squaring of :func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_taylor`,
    for fixed-step solvers whose step norm is bounded."""
    if expm_method == "taylor":
        return lambda a: expm_taylor(a, order=expm_order, squarings=expm_squarings)
    if expm_method == "pade":
        return expm_pade
    raise DynamicsError(f"expm_method {expm_method} not supported (use 'pade' or 'taylor').")


def jax_expm_solver(
    generator,
    t_span,
    y0,
    max_dt,
    t_eval=None,
    magnus_order: int = 1,
    expm_method: str = "pade",
    expm_order: int = 12,
    expm_squarings: int = 2,
):
    """Fixed-step matrix-exponential solver on the device of ``y0`` (a tensor)."""
    expm_func = _select_expm(expm_method, expm_order, expm_squarings)
    take_step = get_exponential_take_step(magnus_order, expm_func=expm_func)
    return fixed_step_solver_template_jax(
        take_step, rhs_func=_on_device(generator, y0), t_span=t_span, y0=y0, max_dt=max_dt,
        t_eval=t_eval,
    )


def lanczos_diag_solver(generator, t_span, y0, max_dt, k_dim, t_eval=None):
    """Fixed-step Krylov (Lanczos) expm-action solver (numpy)."""
    generator = _on_host(generator)

    def take_step(gen, t0, y, h):
        return lanczos_expm(gen(t0 + h / 2), y, k_dim, h)

    return fixed_step_solver_template(
        take_step, rhs_func=generator, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def jax_lanczos_diag_solver(generator, t_span, y0, max_dt, k_dim, t_eval=None):
    """Fixed-step Krylov (Lanczos) expm-action solver on the device of ``y0``."""

    def take_step(gen, t0, y, h):
        return jax_lanczos_expm(gen(t0 + h / 2), y, k_dim, h)

    return fixed_step_solver_template_jax(
        take_step, rhs_func=_on_device(generator, y0), t_span=t_span, y0=y0, max_dt=max_dt,
        t_eval=t_eval,
    )


def jax_expm_parallel_solver(
    generator,
    t_span,
    y0,
    max_dt,
    t_eval=None,
    magnus_order: int = 1,
    expm_method: str = "pade",
    expm_order: int = 12,
    expm_squarings: int = 2,
):
    """Parallel expm solver: every step's Magnus exponent, one batched expm,
    and a log-depth propagator scan."""
    expm_func = _select_expm(expm_method, expm_order, expm_squarings)
    exponent = get_magnus_exponent(magnus_order)
    generator = _on_device(generator, y0)

    def step_propagators(times, steps):
        return expm_func(torch.stack([exponent(generator, t, h) for t, h in zip(times, steps)]))

    return fixed_step_lmde_solver_parallel_template_jax(
        step_propagators, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def jax_RK4_parallel_solver(generator, t_span, y0, max_dt, t_eval=None):
    """Parallel RK4 solver for LMDEs: per-step RK4 propagators and a log-depth
    propagator scan. The identity takes the state's first axis (the JAX
    package takes its last, which fails for an (n, m) state with m != n)."""
    ident = torch.eye(y0.shape[0], dtype=y0.dtype, device=y0.device)
    generator = _on_device(generator, y0)

    def take_step(t, h):
        h2 = 0.5 * h
        gh2 = generator(t + h2)
        k1 = generator(t)
        k2 = gh2 @ (ident + h2 * k1)
        k3 = gh2 @ (ident + h2 * k2)
        k4 = generator(t + h) @ (ident + h * k3)
        return ident + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def step_propagators(times, steps):
        return torch.stack([take_step(t, h) for t, h in zip(times, steps)])

    return fixed_step_lmde_solver_parallel_template_jax(
        step_propagators, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def _matrix_commutator(m1, m2):
    return m1 @ m2 - m2 @ m1


def get_magnus_exponent(magnus_order: int) -> Callable:
    """The exponent ``Omega(t0, h)`` of one step's Magnus rule, orders 1-3.

    Gauss-point generator samples and commutator corrections per Blanes et al.,
    "The Magnus expansion and some of its applications" (2009). Order 1 is the
    midpoint rule ``G(t+h/2) h``.
    """
    if magnus_order == 1:

        def exponent(generator, t0, h):
            return generator(t0 + h / 2) * h

    elif magnus_order == 2:
        c1 = 0.5 - np.sqrt(3) / 6
        c2 = 0.5 + np.sqrt(3) / 6
        p2 = np.sqrt(3) / 12

        def exponent(generator, t0, h):
            g1 = generator(t0 + c1 * h)
            g2 = generator(t0 + c2 * h)
            return h * (g1 + g2) / 2 + p2 * (h**2) * _matrix_commutator(g2, g1)

    elif magnus_order == 3:
        d1 = 0.5 - np.sqrt(15) / 10
        d2 = 0.5
        d3 = 0.5 + np.sqrt(15) / 10
        c0 = np.sqrt(15) / 3
        c1 = 10.0 / 3

        def exponent(generator, t0, h):
            g1 = generator(t0 + d1 * h)
            g2 = generator(t0 + d2 * h)
            g3 = generator(t0 + d3 * h)
            a1 = h * g2
            a2 = c0 * h * (g3 - g1)
            a3 = c1 * h * (g3 - 2 * g2 + g1)
            comm1 = _matrix_commutator(a1, a2)
            comm2 = _matrix_commutator(2 * a3 + comm1, a1) / 60
            return a1 + (a3 / 12) + _matrix_commutator(-20 * a1 - a3 + comm1, a2 + comm2) / 240

    else:
        raise DynamicsError("Only magnus_order 1, 2, and 3 are supported.")
    return exponent


def get_exponential_take_step(magnus_order: int, expm_func: Callable, just_propagator=False):
    """Single-step propagator rules for Magnus orders 1-3: ``expm_func`` of
    :func:`get_magnus_exponent`'s exponent, applied to the state unless
    ``just_propagator``."""
    exponent = get_magnus_exponent(magnus_order)

    def propagator(generator, t0, h):
        return expm_func(exponent(generator, t0, h))

    if just_propagator:
        return propagator

    def take_step(generator, t0, y, h):
        return propagator(generator, t0, h) @ y

    return take_step


def _fixed_step_loop(take_step, rhs_func, t_span, y0, max_dt, t_eval):
    """The states at the merged times: each interval cut into equal steps."""
    t_list, h_list, n_steps_list = get_fixed_step_sizes(t_span, t_eval, max_dt)
    ys = [y0]
    for current_t, h, n_steps in zip(t_list, h_list, n_steps_list):
        y = ys[-1]
        inner_t, h = float(current_t), float(h)
        for _ in range(int(n_steps)):
            y = take_step(rhs_func, inner_t, y, h)
            inner_t = inner_t + h
        ys.append(y)
    return t_list, ys


def fixed_step_solver_template(take_step, rhs_func, t_span, y0, max_dt, t_eval=None):
    """Host-loop fixed-step template: subdivide each interval into <= max_dt steps."""
    t_list, ys = _fixed_step_loop(take_step, rhs_func, t_span, to_numpy(y0), max_dt, t_eval)
    return trim_t_results(OdeResult(t=t_list, y=np.asarray(ys)), t_eval)


def fixed_step_solver_template_jax(take_step, rhs_func, t_span, y0, max_dt, t_eval=None):
    """Device fixed-step template: the same loop on tensors, one Python step at
    a time (the JAX package's ``lax.scan`` with masked inner steps); the
    states stay on ``y0``'s device."""
    t_list, ys = _fixed_step_loop(take_step, rhs_func, t_span, y0, max_dt, t_eval)
    return trim_t_results(OdeResult(t=t_list, y=torch.stack(ys)), t_eval)


def fixed_step_lmde_solver_parallel_template_jax(
    step_propagators, t_span, y0, max_dt, t_eval=None
):
    """Parallel fixed-step LMDE template.

    ``step_propagators(times, steps)`` returns the ``(N, n, n)`` stack of every
    step's propagator (step k starts at ``times[k]`` and lasts ``steps[k]``);
    :func:`~qiskit_dynamics_tpu_torch.parallel.scan.propagator_scan` composes
    them in ``ceil(log2 N)`` batched products, and the states at the merged
    times are read off the cumulative products.
    """
    t_list, h_list, n_steps_list = get_fixed_step_sizes(t_span, t_eval, max_dt)

    all_times = []
    all_h = []
    t_list_locations = [0]
    for t, h, n_steps in zip(t_list, h_list, n_steps_list):
        all_times = np.append(all_times, t + h * np.arange(n_steps))
        all_h = np.append(all_h, h * np.ones(n_steps))
        t_list_locations = np.append(t_list_locations, [t_list_locations[-1] + n_steps])
    t_list_locations = torch.as_tensor(t_list_locations.astype(np.int64), device=y0.device)

    props = step_propagators([float(t) for t in all_times], [float(h) for h in all_h])
    if y0.ndim == 2 and y0.shape[0] == y0.shape[1]:
        intermediate = propagator_scan(torch.cat([y0[None].to(props.dtype), props]))
        ys = intermediate[t_list_locations]
    else:
        intermediate = propagator_scan(props)
        intermediate_y = intermediate[t_list_locations[1:] - 1] @ y0.to(props.dtype)
        ys = torch.cat([y0[None].to(intermediate_y.dtype), intermediate_y])
    return trim_t_results(OdeResult(t=t_list, y=ys), t_eval)


def merge_t_args(t_span, t_eval=None) -> np.ndarray:
    """Merge ``t_span`` and ``t_eval`` into one increasing/decreasing array
    (scipy-style validation)."""
    if t_eval is None:
        return np.asarray(t_span)
    t_span = np.asarray(t_span)
    t_min, t_max = np.min(t_span), np.max(t_span)
    t_direction = np.sign(t_span[1] - t_span[0])
    t_eval = np.asarray(t_eval)
    if t_eval.ndim > 1:
        raise ValueError("t_eval must be 1 dimensional.")
    if np.min(t_eval) < t_min or np.max(t_eval) > t_max:
        raise ValueError("t_eval entries must lie in t_span.")
    if np.any(t_direction * np.diff(t_eval) < 0.0):
        raise ValueError("t_eval must be ordered according to the direction of integration.")
    return np.append(np.append(t_span[0], t_eval), t_span[1])


def get_fixed_step_sizes(t_span, t_eval, max_dt: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merged times, per-interval step sizes ``<= max_dt`` and step counts."""
    t_span = np.asarray(t_span)
    max_dt = np.asarray(max_dt)
    t_list = np.asarray(merge_t_args(t_span, t_eval))

    delta_t_list = np.diff(t_list)
    n_steps_list = np.abs(delta_t_list / max_dt).astype(int)
    for idx, (delta_t, n_steps) in enumerate(zip(delta_t_list, n_steps_list)):
        if n_steps == 0:
            n_steps_list[idx] = 1
        elif np.abs(delta_t / n_steps) / max_dt > 1 + 1e-15:
            n_steps_list[idx] = n_steps + 1

    h_list = np.asarray(delta_t_list / n_steps_list)
    return t_list, h_list, n_steps_list
