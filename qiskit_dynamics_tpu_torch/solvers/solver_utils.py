"""Solver utilities: model predicates, time-argument bookkeeping and batch
broadcasting.

Counterpart of ``qiskit_dynamics_tpu/solvers/solver_utils.py``.
``merge_t_args`` (with ``get_fixed_step_sizes``) lives in
:mod:`.fixed_step_solvers`; :func:`trim_t_results` undoes it. The JAX
package's ``_jax`` variants exist to run under a trace, signalling invalid
input by NaN-poisoning; the port has no trace, so
:func:`merge_t_args_jax` validates as :func:`merge_t_args` does (it raises)
and keeps only what the adaptive stepper needs from them: duplicated
endpoint times are moved to interval midpoints, and :func:`trim_t_results_jax`
undoes that on the result tensors. The names stay so call sites port
unchanged.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..models import LindbladModel
from .results import OdeResult

__all__ = [
    "is_lindblad_model_vectorized",
    "is_lindblad_model_not_vectorized",
    "trim_t_results",
    "merge_t_args_jax",
    "trim_t_results_jax",
    "setup_args_lists",
]


def is_lindblad_model_vectorized(obj) -> bool:
    """True if obj is a vectorized LindbladModel."""
    return isinstance(obj, LindbladModel) and obj.vectorized


def is_lindblad_model_not_vectorized(obj) -> bool:
    """True if obj is a non-vectorized LindbladModel."""
    return isinstance(obj, LindbladModel) and not obj.vectorized


def trim_t_results(results: OdeResult, t_eval=None) -> OdeResult:
    """Remove the added t_span endpoints when ``t_eval`` was given."""
    if t_eval is None:
        return results
    results.t = results.t[1:-1]
    results.y = results.y[1:-1]
    return results


def merge_t_args_jax(t_span, t_eval=None) -> np.ndarray:
    """:func:`~.fixed_step_solvers.merge_t_args` for the adaptive stepper:
    the same validation (it raises), and duplicated endpoint entries shifted to
    interval midpoints (a zero-length interval would stall the stepper)."""
    from .fixed_step_solvers import merge_t_args

    out = np.asarray(merge_t_args(t_span, t_eval), dtype=float)
    if t_eval is None:
        return out
    out = out.copy()
    if out[0] == out[1]:
        out[1] = (out[2] + out[0]) / 2
    if out[-1] == out[-2]:
        out[-2] = (out[-3] + out[-1]) / 2
    return out


def trim_t_results_jax(results: OdeResult, t_eval=None) -> OdeResult:
    """:func:`trim_t_results` after :func:`merge_t_args_jax`: a shifted
    duplicate endpoint reports the endpoint's state, and a zero-length
    ``t_span`` reports ``y0`` at its end. ``results.y`` is a tensor with time
    on axis 0."""
    y = results.y
    if t_eval is not None:
        t_eval = np.asarray(t_eval)
        y = torch.cat([y[:1], y[2:]]) if t_eval[0] == results.t[0] else y[1:]
        y = torch.cat([y[:-2], y[-1:]]) if t_eval[-1] == results.t[-1] else y[:-1]
        results.t = t_eval
    t = np.asarray(results.t)
    if t[0] == t[-1]:
        y = torch.cat([y[:-1], y[:1]])
    results.y = y
    return results


def setup_args_lists(
    args_list: List, args_names: List[str], args_to_list: List[Callable]
) -> Tuple[List[List], bool]:
    """Broadcast a group of possibly-listed args to lists of equal length."""
    args_as_lists = []
    args_were_lists = False
    for arg, to_list in zip(args_list, args_to_list):
        arg_as_list, arg_was_list = to_list(arg)
        args_as_lists.append(arg_as_list)
        args_were_lists = args_were_lists or arg_was_list

    arg_lens = [len(x) for x in args_as_lists]
    max_len = max(arg_lens)
    for idx, arg_len in enumerate(arg_lens):
        if arg_len not in (1, max_len):
            max_name = args_names[arg_lens.index(max_len)]
            names = ", ".join(args_names[:-1]) + f", and {args_names[-1]}"
            raise DynamicsError(
                f"If one of {names} is given as a list of valid inputs, then the others must "
                f"specify only a single input, or a list of the same length. {max_name} "
                f"specifies {max_len} inputs, but {args_names[idx]} is of length {arg_len}, "
                "which is incompatible."
            )

    args_as_lists = [
        x * max_len if arg_len == 1 else x for x, arg_len in zip(args_as_lists, arg_lens)
    ]
    return args_as_lists, args_were_lists
