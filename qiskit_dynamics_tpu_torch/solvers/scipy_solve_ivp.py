"""Host-side scipy ``solve_ivp`` bridge.

Counterpart of ``qiskit_dynamics_tpu/solvers/scipy_solve_ivp.py``. The
integration runs in float64/complex128 numpy; the right-hand side may
return a tensor on any device and is brought to the host on every call.
Flattens arbitrary state shapes and embeds complex states into real vectors
for the real-only methods (LSODA, Radau).
"""
from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from ..exceptions import DynamicsError
from ..unified import to_numpy
from .results import OdeResult

COMPLEX_METHODS = ["RK45", "RK23", "BDF", "DOP853"]
REAL_METHODS = ["LSODA", "Radau"]
SOLVE_IVP_METHODS = COMPLEX_METHODS + REAL_METHODS

__all__ = ["scipy_solve_ivp", "SOLVE_IVP_METHODS"]


def scipy_solve_ivp(rhs, t_span, y0, method, t_eval=None, **kwargs) -> OdeResult:
    """Call ``scipy.integrate.solve_ivp`` with shape/complex handling."""
    if kwargs.get("dense_output", False) is True:
        raise DynamicsError("dense_output not supported for solve_ivp.")

    y0 = to_numpy(y0)
    y_shape = y0.shape
    y0 = y0.flatten()
    rhs = _flat_rhs(rhs, y_shape)

    embed_real = method in REAL_METHODS
    if embed_real:
        rhs = _real_rhs(rhs)
        y0 = _c2r(y0)

    results = solve_ivp(rhs, t_span=t_span, y0=y0, t_eval=t_eval, method=method, **kwargs)
    if embed_real:
        results.y = _r2c(results.y)

    out = OdeResult(**dict(results.items()))
    out.y = np.array([y.reshape(y_shape) for y in results.y.T])
    return out


def _flat_rhs(rhs, shape):
    def flat(t, y):
        return to_numpy(rhs(t, y.reshape(shape))).flatten()

    return flat


def _real_rhs(rhs):
    def real(t, y):
        return _c2r(rhs(t, _r2c(y)))

    return real


def _c2r(arr):
    return np.concatenate([np.real(arr), np.imag(arr)])


def _r2c(arr):
    size = arr.shape[0] // 2
    return arr[:size] + 1j * arr[size:]
