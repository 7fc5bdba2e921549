r"""Chebyshev-interpolated parameter sweeps: 1e-8-class sweeps from a few dozen solves.

Counterpart of ``qiskit_dynamics_tpu/solvers/sweep_interpolation.py``. The
final state of a linear ODE whose generator depends analytically on a scalar
parameter ``p`` is an entire function of ``p``, so its Chebyshev interpolant on
the sweep interval converges super-geometrically. These functions solve the
model at nested Chebyshev-Lobatto nodes with a high-precision inner solver
(default: ``fused_sweep_solve(precision="df32")``, native FP64 through kernel
B8 on the card), certify the interpolant a posteriori against each
refinement's freshly solved nodes, and evaluate it at every sweep point with
one complex128 matrix product on the states' device.

Node placement, refinement and the certificate are host decisions (numpy, as
in the JAX package); the node states and the reconstruction stay on the
device of the inner solver's result.

Scope: a sweep-level algorithm (the win is real only when the sweep has many
more points than nodes); it needs the solution to be smooth in the swept
parameters, and a non-smooth ``signals_fn`` fails the certificate loudly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..unified import is_tensor, to_numpy

__all__ = [
    "interpolated_sweep_solve",
    "interpolated_sweep_solve_2d",
    "SweepInterpolationInfo",
    "SweepInterpolation2DInfo",
]


class SweepInterpolationInfo(NamedTuple):
    """Diagnostics of an interpolated sweep solve."""

    n_nodes: int            #: Chebyshev-Lobatto nodes solved in total
    est_error: float        #: certified a posteriori max-abs error estimate
    levels: int             #: refinement levels used (incl. the initial one)
    node_params: np.ndarray  #: the solved node parameter values
    converged: bool         #: whether est_error <= tol was reached


class SweepInterpolation2DInfo(NamedTuple):
    """Diagnostics of a 2-d interpolated sweep solve."""

    n_nodes: int                 #: total node solves across both axes
    est_error: float             #: certified a posteriori max-abs error
    levels: Tuple[int, int]      #: final Lobatto level per axis
    node_params: Tuple[np.ndarray, np.ndarray]  #: node values per axis
    converged: bool              #: whether est_error <= tol was reached


def _lobatto_params(level: int, lo: float, hi: float) -> np.ndarray:
    """All Chebyshev-Lobatto nodes of ``2**level + 1`` points on [lo, hi]."""
    n = 2**level
    x = np.cos(np.pi * np.arange(n + 1) / n)  # [1 ... -1]
    return lo + (hi - lo) * (1.0 - x) / 2.0


def _chebyshev_matrix(params: np.ndarray, lo: float, hi: float, m: int) -> np.ndarray:
    """(B, m) Chebyshev-T Vandermonde of the sweep points on [lo, hi]."""
    x = np.clip(2.0 * (np.asarray(params, dtype=np.float64) - lo) / (hi - lo) - 1.0, -1.0, 1.0)
    return np.polynomial.chebyshev.chebvander(x, m - 1)


def _on(matrix: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host float64 matrix in the dtype and on the device of ``like``."""
    return torch.as_tensor(matrix, device=like.device).to(like.dtype)


def _lobatto_to_cheb_coeffs(values: torch.Tensor) -> torch.Tensor:
    """Chebyshev coefficients from Lobatto samples (DCT-I as one explicit
    matrix product). ``values``: (N+1, ...) samples at ``cos(j pi / N)``,
    i.e. descending in ``x`` (callers holding ascending-parameter samples
    pass ``values.flip(0)``). Returns (N+1, ...) coefficients ``c_m`` with
    ``f(x) = sum_m c_m T_m(x)``."""
    n = values.shape[0] - 1
    j = np.arange(n + 1)
    w = np.ones(n + 1)
    w[0] = w[-1] = 0.5
    dct = (2.0 / n) * np.cos(np.pi * np.outer(j, j) / n) * w[None, :]
    dct[0] *= 0.5
    dct[-1] *= 0.5
    return (_on(dct, values) @ values.reshape(n + 1, -1)).reshape(values.shape)


def _as_states(x) -> torch.Tensor:
    """A node solver's result as a complex128 tensor."""
    return (x if is_tensor(x) else torch.as_tensor(np.asarray(x))).to(torch.complex128)


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _reject_grad(params, name: str):
    leaves = params if isinstance(params, (tuple, list)) else [params]
    if any(is_tensor(x) and x.requires_grad for x in leaves):
        raise DynamicsError(
            f"{name} is host-facing: node placement and the certificate are host decisions, "
            "so params must not require grad."
        )


def interpolated_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    tol: float = 1e-8,
    min_level: int = 4,
    max_level: int = 9,
    node_solver: Optional[Callable] = None,
    full_output: bool = False,
    rwa_signal_map: Optional[Callable] = None,
    **solver_kwargs,
):
    r"""Solve a 1-d scalar parameter sweep by adaptive Chebyshev interpolation.

    Args:
        model: as in :func:`~qiskit_dynamics_tpu_torch.solvers.fused_sweep.fused_sweep_solve`.
        signals_fn: maps one scalar parameter to the model's signals.
        params: (B,) scalar sweep values (any order, not necessarily uniform).
        t_span: ``(t0, tf)``.
        y0: shared initial state.
        tol: target max-abs interpolation error, certified at each
            refinement's new nodes. The total error adds the inner solver's.
        min_level / max_level: refinement bounds; level ``l`` uses
            ``2**l + 1`` Lobatto nodes (nested under doubling). Not reaching
            ``tol`` at ``max_level`` raises ``DynamicsError``.
        node_solver: optional ``(node_params,) -> (M, ...)`` states. Default:
            ``fused_sweep_solve`` with ``precision="df32"`` and
            ``solver_kwargs`` (e.g. ``max_dt``) forwarded.
        full_output: also return a :class:`SweepInterpolationInfo`.
        rwa_signal_map, solver_kwargs: forwarded to the default node solver.

    Returns:
        (B, ...) complex128 final states on the node states' device (the
        model's), or ``(states, info)`` with ``full_output=True``.
    """
    _reject_grad(params, "interpolated_sweep_solve")
    p = to_numpy(params).astype(np.float64)
    if p.ndim != 1 or p.size < 2:
        raise DynamicsError(
            "interpolated_sweep_solve sweeps exactly one scalar parameter: params must be 1-d "
            f"with >= 2 entries, got shape {p.shape}."
        )
    lo, hi = float(np.min(p)), float(np.max(p))
    if hi <= lo:
        raise DynamicsError("params must span a nonzero interval.")
    if not 1 <= min_level < max_level:
        raise DynamicsError(
            "need 1 <= min_level < max_level (at least one refinement is required — the error "
            "certificate comes from comparing against the next level's freshly solved nodes)."
        )

    if node_solver is None:
        from .fused_sweep import fused_sweep_solve

        solver_kwargs.setdefault("precision", "df32")

        def node_solver(node_params):
            return fused_sweep_solve(
                model, signals_fn, node_params, t_span=t_span, y0=y0,
                rwa_signal_map=rwa_signal_map, **solver_kwargs,
            )

    level = min_level
    node_p = _lobatto_params(level, lo, hi)
    values = _as_states(node_solver(node_p))  # (M, ...)
    est_error = np.inf
    converged = False

    while True:
        coeffs = _lobatto_to_cheb_coeffs(values.flip(0))
        if level >= max_level:
            break
        # solve the new (odd-index) nodes of the next level and certify the
        # current interpolant against them
        next_p = _lobatto_params(level + 1, lo, hi)
        new_p = next_p[1::2]
        new_vals = _as_states(node_solver(new_p)).to(values.device)
        flat_coef = coeffs.reshape(coeffs.shape[0], -1)
        pred = (_on(_chebyshev_matrix(new_p, lo, hi, coeffs.shape[0]), flat_coef) @ flat_coef)
        est_error = _max_abs(pred.reshape(new_vals.shape), new_vals)

        merged = torch.empty((next_p.size,) + tuple(values.shape[1:]), dtype=values.dtype,
                             device=values.device)
        merged[0::2] = values
        merged[1::2] = new_vals
        values, node_p, level = merged, next_p, level + 1

        if est_error <= tol:
            converged = True
            coeffs = _lobatto_to_cheb_coeffs(values.flip(0))
            break

    if not converged and est_error > tol:
        raise DynamicsError(
            f"interpolated_sweep_solve did not reach tol={tol:.1e} by max_level={max_level} "
            f"({node_p.size} nodes): certified error estimate {est_error:.2e}. The solution may "
            "oscillate faster than the node budget resolves (raise max_level) or signals_fn may "
            "be non-smooth in the parameter (this method then does not apply — use a direct "
            "per-point sweep)."
        )

    flat_coef = coeffs.reshape(coeffs.shape[0], -1)
    out = (_on(_chebyshev_matrix(p, lo, hi, coeffs.shape[0]), flat_coef) @ flat_coef).reshape(
        (p.size,) + tuple(values.shape[1:])
    )
    if full_output:
        info = SweepInterpolationInfo(
            n_nodes=int(node_p.size),
            est_error=float(est_error),
            levels=level - min_level + 1,
            node_params=node_p,
            converged=bool(converged),
        )
        return out, info
    return out


def _cheb_coeffs_2d(values: torch.Tensor) -> torch.Tensor:
    """Tensor-product Chebyshev coefficients of (N1+1, N2+1, ...) Lobatto
    samples in ascending parameter order along both axes."""
    c = _lobatto_to_cheb_coeffs(values.flip(0))
    c = torch.movedim(c, 1, 0)
    c = _lobatto_to_cheb_coeffs(c.flip(0))
    return torch.movedim(c, 1, 0)


def _eval_2d(coeffs, x1, x2, lo1, hi1, lo2, hi2, product_grid: bool):
    """Evaluate the tensor interpolant at points (scattered or a product grid)."""
    m1, m2 = coeffs.shape[0], coeffs.shape[1]
    flat = coeffs.reshape(m1, m2, -1)
    v1 = _on(_chebyshev_matrix(x1, lo1, hi1, m1), flat)  # (B1, m1)
    v2 = _on(_chebyshev_matrix(x2, lo2, hi2, m2), flat)  # (B2, m2)
    if product_grid:
        out = torch.einsum("ai,ijs,bj->abs", v1, flat, v2)
        return out.reshape((x1.size, x2.size) + tuple(coeffs.shape[2:]))
    out = torch.einsum("bi,ijs,bj->bs", v1, flat, v2)
    return out.reshape((x1.size,) + tuple(coeffs.shape[2:]))


def interpolated_sweep_solve_2d(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    tol: float = 1e-8,
    min_level: int = 3,
    max_level: int = 7,
    node_solver: Optional[Callable] = None,
    full_output: bool = False,
    rwa_signal_map: Optional[Callable] = None,
    **solver_kwargs,
):
    r"""Solve a 2-d scalar-pair sweep by adaptive tensor-Chebyshev interpolation.

    The model is solved on a nested Chebyshev-Lobatto product grid and the
    sweep is reconstructed through a tensor-product interpolant. Refinement
    is anisotropic: each round doubles the axis whose Chebyshev tail (max
    ``|c|`` over the top half of orders) is larger. Each refinement's new
    nodes are compared with the previous interpolant before they are merged,
    and a final batch of 16 seeded off-node points checks both axes at once.

    Args:
        model: as in :func:`~.fused_sweep.fused_sweep_solve`.
        signals_fn: maps a ``(p1, p2)`` pair (each scalar or batched) to the
            model's signals.
        params: a tuple ``(p1_vals, p2_vals)`` of 1-d arrays (their product
            grid; output ``(len(p1), len(p2), ...)``) or a ``(B, 2)`` array of
            scattered points (output ``(B, ...)``).
        t_span: ``(t0, tf)``.
        y0: shared initial state.
        tol: certified max-abs interpolation error target.
        min_level / max_level: per-axis Lobatto levels (``2**l + 1`` nodes).
        node_solver: optional ``(p1_flat, p2_flat) -> (M, ...)``; default
            ``fused_sweep_solve(precision="df32")``.
        full_output: also return :class:`SweepInterpolation2DInfo`.
        rwa_signal_map, solver_kwargs: forwarded to the default node solver.

    Returns:
        complex128 states on the node states' device (see ``params``), or
        ``(states, info)``.
    """
    _reject_grad(params, "interpolated_sweep_solve_2d")
    if isinstance(params, tuple) and len(params) == 2:
        p1 = to_numpy(params[0]).astype(np.float64).ravel()
        p2 = to_numpy(params[1]).astype(np.float64).ravel()
        product_grid = True
    else:
        pts = to_numpy(params).astype(np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise DynamicsError(
                "params must be a (p1_vals, p2_vals) tuple (product grid) or a (B, 2) array of "
                f"points; got shape {pts.shape}."
            )
        p1, p2 = pts[:, 0], pts[:, 1]
        product_grid = False
    lo1, hi1 = float(np.min(p1)), float(np.max(p1))
    lo2, hi2 = float(np.min(p2)), float(np.max(p2))
    if hi1 <= lo1 or hi2 <= lo2:
        raise DynamicsError(
            "both parameters must span nonzero intervals; for a 1-d sweep use "
            "interpolated_sweep_solve."
        )
    if not 1 <= min_level < max_level:
        raise DynamicsError("need 1 <= min_level < max_level.")

    if node_solver is None:
        from .fused_sweep import fused_sweep_solve

        solver_kwargs.setdefault("precision", "df32")

        def node_solver(q1, q2):
            return fused_sweep_solve(
                model, signals_fn, (q1, q2), t_span=t_span, y0=y0,
                rwa_signal_map=rwa_signal_map, **solver_kwargs,
            )

    l1 = l2 = min_level
    n1 = _lobatto_params(l1, lo1, hi1)
    n2 = _lobatto_params(l2, lo2, hi2)
    g1, g2 = np.meshgrid(n1, n2, indexing="ij")
    values = _as_states(node_solver(g1.ravel(), g2.ravel()))
    state_shape = tuple(values.shape[1:])
    values = values.reshape((n1.size, n2.size) + state_shape)
    n_nodes = n1.size * n2.size
    est_error = np.inf
    converged = False

    while True:
        coeffs = _cheb_coeffs_2d(values)
        if l1 >= max_level and l2 >= max_level:
            break
        # the axis with the larger Chebyshev tail
        m1, m2 = coeffs.shape[0], coeffs.shape[1]
        flatc = coeffs.reshape(m1, m2, -1).abs()
        tail1 = float(flatc[m1 // 2:, :, :].max()) if l1 < max_level else -1.0
        tail2 = float(flatc[:, m2 // 2:, :].max()) if l2 < max_level else -1.0
        axis = 0 if tail1 >= tail2 else 1

        if axis == 0:
            next_n = _lobatto_params(l1 + 1, lo1, hi1)
            new_n = next_n[1::2]
            gg1, gg2 = np.meshgrid(new_n, n2, indexing="ij")
        else:
            next_n = _lobatto_params(l2 + 1, lo2, hi2)
            new_n = next_n[1::2]
            gg1, gg2 = np.meshgrid(n1, new_n, indexing="ij")
        new_vals = _as_states(node_solver(gg1.ravel(), gg2.ravel())).to(values.device)
        new_vals = new_vals.reshape(gg1.shape + state_shape)
        n_nodes += gg1.size
        pred = _eval_2d(coeffs, gg1.ravel(), gg2.ravel(), lo1, hi1, lo2, hi2, False)
        est_error = _max_abs(pred.reshape(new_vals.shape), new_vals)

        # merge (old nodes interleave with new along the refined axis)
        if axis == 0:
            merged = torch.empty((next_n.size, n2.size) + state_shape, dtype=values.dtype,
                                 device=values.device)
            merged[0::2] = values
            merged[1::2] = new_vals
            values, n1, l1 = merged, next_n, l1 + 1
        else:
            merged = torch.empty((n1.size, next_n.size) + state_shape, dtype=values.dtype,
                                 device=values.device)
            merged[:, 0::2] = values
            merged[:, 1::2] = new_vals
            values, n2, l2 = merged, next_n, l2 + 1

        if est_error <= tol:
            converged = True
            coeffs = _cheb_coeffs_2d(values)
            break

    if not converged and est_error > tol:
        raise DynamicsError(
            f"interpolated_sweep_solve_2d did not reach tol={tol:.1e} by max_level={max_level} "
            f"per axis ({n1.size}x{n2.size} nodes): certified error estimate {est_error:.2e}. "
            "Raise max_level or check that signals_fn is smooth in both parameters."
        )

    # off-node probe points: the per-refinement certificate samples at the
    # other axis's nodes, where that axis is exact by construction; points
    # off both node sets close that hole (seeded, reproducible)
    rng = np.random.default_rng(0)
    q1 = rng.uniform(lo1, hi1, size=16)
    q2 = rng.uniform(lo2, hi2, size=16)
    probe_vals = _as_states(node_solver(q1, q2)).to(values.device).reshape((16,) + state_shape)
    n_nodes += 16
    probe_pred = _eval_2d(coeffs, q1, q2, lo1, hi1, lo2, hi2, False).reshape(probe_vals.shape)
    probe_err = _max_abs(probe_pred, probe_vals)
    est_error = max(est_error, probe_err)
    if probe_err > 10 * tol:  # interpolation error, not inner-solver noise
        raise DynamicsError(
            f"interpolated_sweep_solve_2d: off-node probe certification failed ({probe_err:.2e} "
            f"vs tol={tol:.1e}) after the per-axis certificates passed — the anisotropic "
            "refinement under-resolved one axis. Raise min_level or tighten tol."
        )

    out = _eval_2d(coeffs, p1, p2, lo1, hi1, lo2, hi2, product_grid)
    if full_output:
        info = SweepInterpolation2DInfo(
            n_nodes=int(n_nodes),
            est_error=float(est_error),
            levels=(int(l1), int(l2)),
            node_params=(n1, n2),
            converged=bool(converged),
        )
        return out, info
    return out
