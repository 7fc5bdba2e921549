"""Adaptive embedded Runge-Kutta solvers on the device.

Counterpart of ``qiskit_dynamics_tpu/solvers/adaptive.py``: adaptive
Dormand-Prince 5(4) (``tpu_dopri5``) and DOP853 (``tpu_dop853``) with the
same tableaus (:mod:`~qiskit_dynamics_tpu_torch.ops.rk_tableaus`), initial-step
rule, error norms and step control (scipy's safety, min and max factors), and
the same output semantics:

- it lands exactly on the requested output times by clipping steps to the
  next target (no interpolation error);
- backwards integration runs by time reflection;
- an exhausted step budget NaN-poisons the output (``success`` is False).

The JAX package runs the loop as one compiled ``lax.while_loop`` (or a
bounded ``lax.scan``) on the TPU. Here it is an eager loop: the stages and
the error norm are tensor operations on the device of ``y0``, and each step
reads one number back to the host, the error norm, from which the accept
decision and the next step size follow in float64 on the host (the same
arithmetic as the JAX package under x64). That read synchronizes every step.
Not carried: the JAX package's ``_in_trace`` probe, the self-``jit`` cache
and its complex-safe boundary; ``auto_jit`` and ``stepper`` are accepted so
call sites port unchanged (``stepper`` is validated; both loops compute the
same steps).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import rk_tableaus as _rk
from .results import OdeResult
from .solver_utils import merge_t_args_jax, trim_t_results_jax

__all__ = ["tpu_dopri5", "tpu_dop853", "tpu_rk_solve"]

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


def _cabs(x):
    """|x| as sqrt(re^2 + im^2), the JAX package's formula."""
    if x.is_complex():
        return torch.sqrt(x.real**2 + x.imag**2)
    return torch.abs(x)


def _rms_norm(x):
    return torch.sqrt(torch.mean(_cabs(x) ** 2))


def _combine(weights, K):
    """``sum_i weights[i] K[i]`` over the stages with a nonzero weight, as a
    0-started sum in stage order (the JAX package's ``tensordot`` order may
    differ in the last bits)."""
    out = 0
    for w, k in zip(weights, K):
        if w != 0.0:
            out = out + float(w) * k
    return out


def _dopri5_error_norm(K, h, scale):
    return _rms_norm(h * _combine(_rk.DOPRI5_E, K) / scale)


def _dop853_error_norm(K, h, scale):
    err5 = _combine(_rk.DOP853_E5, K) / scale
    err3 = _combine(_rk.DOP853_E3, K) / scale
    err5_norm_2 = torch.sum(_cabs(err5) ** 2)
    err3_norm_2 = torch.sum(_cabs(err3) ** 2)
    denom = err5_norm_2 + 0.01 * err3_norm_2
    denom = torch.where(denom == 0.0, 1.0, denom)
    return abs(h) * err5_norm_2 / torch.sqrt(denom * err5.numel())


_TABLEAUS = {
    "dopri5": (_rk.DOPRI5_A, _rk.DOPRI5_B, _rk.DOPRI5_C, _rk.DOPRI5_N_STAGES, -1.0 / 5.0,
               _dopri5_error_norm),
    "dop853": (_rk.DOP853_A, _rk.DOP853_B, _rk.DOP853_C, _rk.DOP853_N_STAGES, -1.0 / 8.0,
               _dop853_error_norm),
}


def _select_initial_step(f, t0, y0, f0, err_exp, rtol, atol) -> float:
    """scipy-style initial step heuristic (two extra RHS evaluations); the
    three norms are read to the host."""
    scale = atol + rtol * _cabs(y0)
    d0 = float(_rms_norm(y0 / scale))
    d1 = float(_rms_norm(f0 / scale))
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / (1.0 if d1 == 0 else d1)
    f1 = f(t0 + h0, y0 + h0 * f0)
    d2 = float(_rms_norm((f1 - f0) / scale)) / h0
    md = max(d1, d2)
    h1 = max(1e-6, h0 * 1e-3) if md <= 1e-15 else (0.01 / md) ** (-err_exp)
    return min(100 * h0, h1)


def tpu_rk_solve(
    rhs: Callable,
    t_span,
    y0,
    t_eval=None,
    method: str = "dopri5",
    rtol: float = 1e-8,
    atol: float = 1e-10,
    max_steps: int = 16384,
    first_step: Optional[float] = None,
    auto_jit: bool = True,
    stepper: str = "auto",
):
    """Adaptive embedded-RK solve of ``dy/dt = rhs(t, y)`` on ``y0``'s device.

    Returns an :class:`OdeResult` with the states (a tensor, time on axis 0)
    at the merged ``t_span``/``t_eval`` time points (exact stopping, no
    interpolation), ``nfev`` and ``success``. An eager loop: one host read
    of the error norm per step (see the module docstring). ``auto_jit`` is
    accepted and ignored; ``stepper`` is ``"auto"``, ``"while"`` or
    ``"scan"``, all the same loop here.
    """
    if stepper not in ("auto", "while", "scan"):
        raise ValueError(f"stepper must be 'auto', 'while' or 'scan', got {stepper!r}")
    if method not in _TABLEAUS:
        raise ValueError(f"method must be 'dopri5' or 'dop853', got {method!r}")
    A, B, C, n_stages, err_exp, error_norm_fn = _TABLEAUS[method]
    if not y0.is_complex() and not y0.is_floating_point():
        y0 = y0.to(torch.float32)

    t_list = merge_t_args_jax(t_span, t_eval)
    n_targets = t_list.shape[0]

    # time reflection so the internal clock always increases
    sigma = 1.0 if t_list[-1] >= t_list[0] else -1.0
    s_list = [sigma * float(t) for t in t_list]

    def f(s, y):
        return sigma * rhs(sigma * s, y)

    s = s_list[0]
    fc = f(s, y0)
    h = (
        _select_initial_step(f, s, y0, fc, err_exp, rtol, atol)
        if first_step is None else float(first_step)
    )

    y = y0
    ys = [y0]
    target_idx, nfev, n_steps = 1, 2, 0
    while target_idx < n_targets and n_steps < max_steps:
        n_steps += 1
        gap = s_list[target_idx] - s
        clipped = h >= gap
        h_eff = gap if clipped else h

        K = [fc]
        for i in range(1, n_stages):
            incr = sum(float(A[i, j]) * K[j] for j in range(i))
            K.append(f(s + float(C[i]) * h_eff, y + h_eff * incr))
        y_new = y + h_eff * sum(float(B[i]) * K[i] for i in range(n_stages))
        f_new = f(s + h_eff, y_new)
        K.append(f_new)
        nfev += n_stages

        scale = atol + rtol * torch.maximum(_cabs(y), _cabs(y_new))
        err_norm = float(error_norm_fn(K, h_eff, scale))  # the step's one host read

        accept = err_norm <= 1.0 or h_eff <= 1e-14 * max(1.0, abs(s))
        raw_factor = _SAFETY * (_MAX_FACTOR if err_norm == 0.0 else err_norm**err_exp)
        factor = min(max(raw_factor, _MIN_FACTOR), _MAX_FACTOR)
        if not accept:
            factor = min(max(factor, _MIN_FACTOR), 1.0)
        h_next = h if (clipped and accept) else h_eff * factor

        if accept:
            s = s + h_eff
            y, fc = y_new, f_new
            if clipped:
                ys.append(y_new)
                target_idx += 1
        h = h_next

    completed = target_idx >= n_targets
    if completed:
        y_out = torch.stack(ys)
    else:  # NaN-poison: the step budget ran out before t_span[1]
        y_out = torch.cat([y0[None], torch.full(
            (n_targets - 1,) + tuple(y0.shape), float("nan"), dtype=y0.dtype, device=y0.device)])
    results = OdeResult(t=t_list, y=y_out, nfev=nfev, success=completed)
    return trim_t_results_jax(results, t_eval)


def tpu_dopri5(rhs, t_span, y0, t_eval=None, **kwargs):
    """Adaptive Dormand-Prince 5(4) on the device (eager loop)."""
    return tpu_rk_solve(rhs, t_span, y0, t_eval=t_eval, method="dopri5", **kwargs)


def tpu_dop853(rhs, t_span, y0, t_eval=None, **kwargs):
    """Adaptive DOP853 (8th order) on the device (eager loop)."""
    return tpu_rk_solve(rhs, t_span, y0, t_eval=t_eval, method="dop853", **kwargs)
