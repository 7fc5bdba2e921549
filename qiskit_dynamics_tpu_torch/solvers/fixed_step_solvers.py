"""The fixed-step grid rule of the JAX package's fixed-step solvers.

Counterpart of ``get_fixed_step_sizes`` in
``qiskit_dynamics_tpu/solvers/fixed_step_solvers.py`` and ``merge_t_args`` in
``qiskit_dynamics_tpu/solvers/solver_utils.py``: each interval between
consecutive times is cut into the fewest equal steps no longer than
``max_dt``. The fused fixed-step sweep uses the same rule, so its grid is the
generic solvers' grid. Host-side numpy. The fixed-step solvers themselves
wait for ROADMAP A12.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["get_fixed_step_sizes", "merge_t_args"]


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
