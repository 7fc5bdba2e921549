r"""Fused sweep solvers: the fixed-step Magnus sweep and the lockstep-adaptive sweep.

Counterpart of ``fused_sweep_solve`` and ``fused_adaptive_sweep_solve`` in
``qiskit_dynamics_tpu/solvers/fused_sweep.py``. Given a model and a
parameterized signal constructor, they build the per-member signal tables
for the whole batch in one ``torch.func.vmap`` pass, map members onto
kernel lanes, run the kernel (CUDA for a model on a CUDA device, the plain
version for a model on the CPU) and rotate the results back to the standard
basis.

- ``fused_sweep_solve``: fixed-step Magnus-2 or Magnus-3 on one of four
  engines: kernel B2 (:mod:`~qiskit_dynamics_tpu_torch.ops.sweep_solver`,
  ``solve_dim <= 32``), the member-major kernel B3
  (:mod:`~qiskit_dynamics_tpu_torch.ops.member_sweep`, up to 128), the
  polynomial engine with the Horner kernel B4
  (:mod:`~qiskit_dynamics_tpu_torch.ops.polynomial_sweep`, above 128), or the
  batch-major eager engine (:mod:`~qiskit_dynamics_tpu_torch.ops.xla_sweep`);
  differentiable (kernel forward, eager backward); Hamiltonian and vectorized
  Lindblad models. ``precision="df32"`` runs the same step rules in native
  FP64 through kernel B8 (:mod:`~qiskit_dynamics_tpu_torch.ops.df_sweep`), on
  a uniform or adaptive, possibly non-uniform, grid with trajectories at
  arbitrary times; the JAX package's double-float32 engine exists because the
  TPU has no FP64.
- ``fused_adaptive_sweep_solve``: lockstep-adaptive dopri5 through kernel B1
  (:mod:`~qiskit_dynamics_tpu_torch.ops.adaptive_sweep`), Hamiltonian models;
  on the card its device work is one CUDA graph per call shape, replayed.

Not yet ported (``ROADMAP.md``): the gradient of the adaptive solve (A5),
``mesh=`` and ``df_devices=`` (A13), and the adaptive solve on Lindblad
models. Not carried: the member engine's Mosaic layout keywords
``member_horner`` and ``member_build`` (one kernel computes that polynomial),
and the JAX package's host-link workarounds of the df32 path
(``_constant_envelope_factors``, ``_rank1_envelope_factors``,
``_sample_coefficients_f64``): the coefficient table is one float64 vmapped
pass on the device here.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..models import GeneratorModel, LindbladModel
from ..models.operator_collections import OperatorCollection, VectorizedLindbladCollection
from ..ops.magnus_rule import MAGNUS_NODES, step_constants
from ..signals import Signal, SignalList
from ..unified import is_tensor, to_numpy, to_tensor
from ..utils import lru, metrics
from ..utils.metrics import annotate_call, span
from .fixed_step_solvers import get_fixed_step_sizes

__all__ = ["fused_sweep_solve", "fused_adaptive_sweep_solve", "sweep_arguments"]


def _extract_generator_data(model, t_span, fn_name: str):
    """Shared validation + frame-basis data extraction for the fused solvers.

    Returns ``(vectorized_lindblad, solve_dim, static_fb, ops_fb, omega, t0,
    tf)``: the static generator and operator stack in the frame basis
    (tensors on the model's device; ``(n^2, n^2)`` superoperators for a
    vectorized ``LindbladModel``) and the float64 frame frequency-difference
    matrix ``omega[a, c] = w_c - w_a``.
    """
    vectorized_lindblad = isinstance(model, LindbladModel)
    if vectorized_lindblad:
        coll = model._operator_collection
        if not isinstance(coll, VectorizedLindbladCollection):
            raise DynamicsError(f"{fn_name} requires a dense vectorized collection.")
        inner = coll._operator_collection
    elif isinstance(model, GeneratorModel):
        inner = model._operator_collection
        if inner.operators is None or not isinstance(inner, OperatorCollection):
            raise DynamicsError(f"{fn_name} requires dense operators.")
    else:
        raise DynamicsError(f"{fn_name} takes a GeneratorModel or a LindbladModel.")

    t0, tf = _time_span(t_span, fn_name)

    solve_dim = model.dim**2 if vectorized_lindblad else model.dim
    static_fb = inner.static_operator
    if static_fb is None:
        static_fb = torch.zeros((solve_dim, solve_dim), dtype=model.dtype, device=model.device)
    ops_fb = inner.operators

    frame_diag = model.rotating_frame.frame_diag
    if frame_diag is None:
        omega = torch.zeros((solve_dim, solve_dim), dtype=torch.float64, device=model.device)
    else:
        w = torch.imag(frame_diag.to(torch.complex128))
        if vectorized_lindblad:
            # column-stacking vec: index a = col*n + row carries the phase
            # w_row - w_col
            w = (w[None, :] - w[:, None]).reshape(-1)
        omega = w[None, :] - w[:, None]
    return vectorized_lindblad, solve_dim, static_fb, ops_fb, omega, t0, tf


def _time_span(t_span, fn_name: str):
    t0, tf = float(t_span[0]), float(t_span[-1])
    if tf <= t0:
        raise DynamicsError(f"{fn_name} requires t_span[1] > t_span[0].")
    return t0, tf


def _all_anti_hermitian(model) -> bool:
    """Whether every frame-basis generator matrix is anti-Hermitian
    (``G = -iH``), checked once per model (the model's operator collection
    keeps the answer). True for Hamiltonian dynamics (real coefficients keep
    a linear combination anti-Hermitian, and the elementwise frame rotation
    preserves it since ``omega`` is antisymmetric); enables the one-matmul
    Magnus-2 commutator."""
    coll = model._operator_collection
    if isinstance(coll, VectorizedLindbladCollection):
        coll = coll._operator_collection
    return coll.anti_hermitian


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor/array leaf of nested tuples/lists/dicts."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, val) for val in tree)
    return fn(tree)


def _leaves(tree):
    """The leaves of nested tuples/lists/dicts, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for val in tree:
            yield from _leaves(val)
    else:
        yield tree


def fused_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    max_dt: float,
    y0,
    expm_order: int = 8,
    tile_b: Optional[int] = None,
    rwa_signal_map: Optional[Callable] = None,
    precision: str = "f32",
    magnus_mode: str = "auto",
    sweep_engine: str = "auto",
    magnus_order: int = 2,
    poly_horner: str = "auto",
    t_eval=None,
    mesh=None,
    df_chunk_b: int = 2048,
    df_magnus_order: int = 3,
    df_engine: str = "auto",
    df_grid: str = "uniform",
    df_grid_tol: float = 1e-9,
    df_fast: bool = True,
    df_horner_tail: int = 6,
    df_devices=None,
):
    r"""Solve ``y' = G_b(t) y`` for a parameter sweep on a fixed step grid.

    Args:
        model: a dense ``GeneratorModel``/``HamiltonianModel``, or a
            ``LindbladModel`` (vectorized; ``y0`` is then a density matrix
            and ``signals_fn`` returns a ``(hamiltonian_signals,
            dissipator_signals)`` tuple). Its device is where the sweep runs.
        signals_fn: one member's parameters -> the model's signals (before
            ``rwa_signal_map``). It is called under ``torch.func.vmap`` over
            axis 0 of ``params`` (tensor arithmetic only).
        params: a tensor (or nested tuple/list/dict of tensors) with the
            sweep on axis 0. If it requires grad, the result is
            differentiable with respect to it.
        t_span: ``(t0, tf)``; the grid is the fewest equal steps no longer
            than ``max_dt`` (the rule of the generic fixed-step solvers).
        max_dt: maximum step size.
        y0: shared initial state, (dim,) or (dim, m) (e.g. the identity);
            (n, n) for a Lindblad model.
        expm_order: Taylor order of the expm action.
        tile_b: lane padding unit of the kernel engine, kept for the JAX
            package's contract. ``None`` pads nothing: the CUDA kernel sizes
            its own blocks and handles a ragged last one, and the plain
            version is batched over members.
        rwa_signal_map: maps ``signals_fn``'s output to the model's signals
            (``Solver.solve_sweep`` wires the solver's map).
        precision: ``"f32"`` (the engines below, float32 on the card) or
            ``"df32"``: the 1e-8-class path, native FP64 through kernel B8
            (the ``df_*`` keywords; see
            :func:`~qiskit_dynamics_tpu_torch.ops.df_sweep.sweep_expm_magnus_df`).
            Its result is a complex128 tensor on the model's device; it has
            no gradient.
        magnus_mode: kernel B2's Magnus-2 evaluation (``"auto"``,
            ``"matrix"``, ``"matrix_herm"``, ``"matvec"``); ignored, with a
            warning, on the other engines (as is ``tile_b``).
        sweep_engine: every engine runs its CUDA kernel for a model on the
            card and the kernel's plain version for a model on the CPU.
            ``"pallas"`` (the name is kept): the fixed-step sweep kernel B2,
            ``solve_dim <= 32``, Magnus-2. ``"member"``: the member-major
            kernel B3, ``solve_dim <= 128`` (``<= 64`` for Magnus-3), vector
            states without ``t_eval``. ``"poly"``: the polynomial-expanded
            engine, whose ``expm`` action is kernel B4. ``"xla"``: the
            batch-major eager engine. ``"auto"`` (default): Magnus-2 takes
            B2 up to 32, the member engine up to 128 (vector states without
            ``t_eval``, else the eager engine) and the polynomial engine
            above; Magnus-3 takes the member engine up to 64 (same
            condition, else the eager engine up to 128) and the polynomial
            engine above 128.
        magnus_order: 2 (2-point Gauss, 4th order) or 3 (3-point Gauss, 6th
            order; not on ``"pallas"``).
        poly_horner: the polynomial engine's ``expm``-action route:
            ``"pallas"`` (kernel B4), ``"einsum"`` (eager loop) or ``"auto"``
            (the kernel for single-column states at ``solve_dim >= 64``).
        t_eval: optional strictly increasing times on the step grid
            ``t0 + j dt``; switches the return to trajectories. With
            ``precision="df32"`` any times in ``t_span``: an off-grid time
            splits the step that contains it.
        mesh: multi-device sharding; waits for ROADMAP A13 (raises).
        df_chunk_b: (df32) members per kernel launch.
        df_magnus_order: (df32) 2 or 3 (default: the 6th-order rule).
        df_engine: (df32) ``"auto"``, ``"xla"`` or ``"pallas"``: the JAX
            package's two engines; all three run kernel B8.
        df_grid: (df32) ``"uniform"`` (``max_dt``-sized equal steps) or
            ``"adaptive"``: a host float64 step-doubling walk of probe
            members builds a non-uniform grid (``max_dt`` is then ignored).
        df_grid_tol: (df32, adaptive grid) target total truncation error.
        df_fast, df_horner_tail: (df32) the JAX package's double-float32
            mixed-precision options; accepted, no-ops (all of it is FP64).
        df_devices: (df32) multi-device dispatch; waits for ROADMAP A13.

    Returns:
        (B, dim) or (B, dim, m) final states at ``t_span[1]`` in the
        standard basis, (B, n, n) density matrices for a Lindblad model;
        with ``t_eval``, ``(B, n_eval, ...)``.
    """
    if precision not in ("f32", "df32"):
        raise DynamicsError(f"unknown precision {precision!r}; use 'f32' or 'df32'.")
    if mesh is not None:
        raise NotImplementedError(
            "fused_sweep_solve(mesh=...) waits for ROADMAP A13 (multi-device, torch.distributed)."
        )
    if magnus_order not in (2, 3):
        raise DynamicsError(f"magnus_order must be 2 or 3, got {magnus_order!r}.")
    vectorized_lindblad, solve_dim, static_fb, ops_fb, omega, t0, tf = _extract_generator_data(
        model, t_span, "fused_sweep_solve"
    )
    device = model.device
    _, h_list, n_steps_list = get_fixed_step_sizes((t0, tf), None, max_dt)
    n_steps, dt = int(n_steps_list[0]), float(h_list[0])

    k = ops_fb.shape[0]

    def signals_as_list(p) -> SignalList:
        sigs = signals_fn(p)
        if rwa_signal_map is not None:
            sigs = rwa_signal_map(sigs)
        if isinstance(sigs, tuple):  # Lindblad: (hamiltonian_signals, dissipator_signals)
            ham_sigs, dis_sigs = sigs
            sigs = list(ham_sigs or []) + list(dis_sigs or [])
        if not isinstance(sigs, SignalList):
            sigs = SignalList(list(sigs))
        if len(sigs) != k:
            raise DynamicsError(
                f"signals_fn (after any rwa_signal_map) must produce {k} signals to "
                f"match the model's operators; got {len(sigs)}."
            )
        return sigs

    frame = model.rotating_frame
    with span("sweep.lanes"):
        if vectorized_lindblad:
            rho_fb = frame.operator_into_frame_basis(y0)
            if rho_fb.shape != (model.dim, model.dim):
                raise DynamicsError("a Lindblad sweep takes a (dim, dim) density matrix y0.")
            y0_fb = rho_fb.T.reshape(-1)  # column-stacking vec
        else:
            y0_fb = frame.state_into_frame_basis(y0)

    if precision == "df32":
        if df_devices is not None:
            raise NotImplementedError(
                "fused_sweep_solve(df_devices=...) waits for ROADMAP A13 (multi-device, "
                "torch.distributed)."
            )
        if df_engine not in ("auto", "xla", "pallas"):
            raise DynamicsError(f"unknown df_engine {df_engine!r}; use 'auto', 'xla' or 'pallas'.")
        if df_magnus_order not in (2, 3):
            raise DynamicsError(f"df_magnus_order must be 2 or 3, got {df_magnus_order!r}.")
        if df_grid == "adaptive":
            dts = _adaptive_df_grid(
                signals_as_list, params, static_fb, ops_fb, omega, t0, tf, df_magnus_order,
                df_grid_tol,
            )
        elif df_grid == "uniform":
            dts = np.full(n_steps, dt)
        else:
            raise DynamicsError(f"unknown df_grid {df_grid!r}; use 'uniform' or 'adaptive'.")
        dts, eval_slots, include_t0 = _df_eval_slots(t_eval, dts, t0, tf)
        return _fused_sweep_solve_df(
            model, signals_as_list, params, dts, static_fb, ops_fb, omega, y0_fb,
            vectorized_lindblad, t0, expm_order, df_chunk_b, df_magnus_order, eval_slots,
            include_t0,
        )

    eval_slots, include_t0 = _fixed_eval_slots(t_eval, t0, tf, dt, n_steps)
    sweep_engine = _select_engine(
        sweep_engine, magnus_order, solve_dim,
        member_ok=t_eval is None and y0_fb.ndim == 1,
    )

    with span("sweep.tables"):
        gauss_times = t0 + dt * (np.arange(n_steps)[:, None] + MAGNUS_NODES[magnus_order][None, :])
        coeffs = _gauss_table(signals_as_list, params, gauss_times, device, torch.float32)
    annotate_call(engine=sweep_engine, members=coeffs.shape[-1])
    hermitian = _all_anti_hermitian(model)

    traj = None
    if sweep_engine != "pallas" and (magnus_mode != "auto" or tile_b is not None):
        warnings.warn(
            f"fused_sweep_solve routed to the {sweep_engine} engine (solve_dim={solve_dim} or "
            f"sweep_engine={sweep_engine!r}); the options magnus_mode and tile_b of the "
            "fixed-step kernel are ignored on this path.",
            stacklevel=2,
        )
    if sweep_engine in ("xla", "poly"):
        # batch-major (B, n, m): each member's generators are built once and
        # applied to all m state columns
        B = coeffs.shape[-1]
        with span("sweep.lanes"):
            y0_mat = y0_fb.reshape(solve_dim, -1)
            m = y0_mat.shape[1]
            y0_bm = y0_mat[None].expand(B, solve_dim, m)
        if sweep_engine == "poly":
            from ..ops.polynomial_sweep import sweep_expm_magnus_poly

            # the frame diagonal (gauge d_0 = 0) from the omega difference
            # matrix: constant shifts of d cancel in every diagonal sandwich
            out = sweep_expm_magnus_poly(
                static_fb, ops_fb, 1j * omega[:, 0], coeffs, y0_bm, dt=dt, t0=t0,
                order=expm_order, eval_slots=eval_slots, magnus_order=magnus_order,
                horner=poly_horner,
            )
        else:
            from ..ops.xla_sweep import sweep_expm_magnus2_xla

            with span("sweep.engine"):
                out = sweep_expm_magnus2_xla(
                    static_fb, ops_fb, omega, coeffs, y0_bm, dt=dt, t0=t0, order=expm_order,
                    hermitian=hermitian, eval_slots=eval_slots, magnus_order=magnus_order,
                )
        with span("sweep.collect"):
            out_final, traj_bm = out if eval_slots is not None else (out, None)
            # back to the member-major lane layout of the collectors
            yf = out_final.permute(1, 0, 2).reshape(solve_dim, B * m)
            if traj_bm is not None:
                traj = traj_bm.permute(0, 2, 1, 3).reshape(-1, solve_dim, B * m)
            y0_cols = y0_mat.repeat(1, B) if m > 1 else y0_mat.expand(solve_dim, B)
    elif sweep_engine == "member":
        from ..ops.member_sweep import sweep_expm_magnus2_member
        from ..ops.sweep_ad import sweep_expm_magnus2_member_ad

        B, m = coeffs.shape[-1], 1
        y0_cols = y0_fb[:, None].expand(solve_dim, B)
        args = (static_fb, ops_fb, omega, coeffs, y0_cols)
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            yf = sweep_expm_magnus2_member_ad(
                *args, dt, t0, expm_order, hermitian, magnus_order
            )
        else:
            yf = sweep_expm_magnus2_member(
                *args, dt=dt, t0=t0, order=expm_order, hermitian=hermitian, magnus=magnus_order
            )
    else:
        from ..ops.sweep_ad import sweep_expm_magnus2_ad
        from ..ops.sweep_solver import sweep_expm_magnus2

        if tile_b is None:
            tile_b = 1  # no padding: the kernel sizes its own blocks
        with span("sweep.lanes"):
            coeffs, y0_cols, B, m = _expand_lanes(coeffs, y0_fb, solve_dim, tile_b)
        args = (static_fb, ops_fb, omega, coeffs, y0_cols)
        kwargs = dict(dt=dt, t0=t0, order=expm_order, hermitian=hermitian, mode=magnus_mode,
                      tile_b=tile_b, eval_slots=eval_slots)
        if torch.is_grad_enabled() and any(x.requires_grad for x in args):
            out = sweep_expm_magnus2_ad(*args, **kwargs)
        else:
            out = sweep_expm_magnus2(*args, **kwargs)
        yf, traj = out if eval_slots is not None else (out, None)

    return _collect_solve(model, yf, traj, y0_cols, t_eval is not None, include_t0, B, m,
                          vectorized_lindblad)


def _gauss_table(signals_as_list, params, gauss_times: np.ndarray, device, dtype) -> torch.Tensor:
    """The (T, n_nodes, k, B) signal values of every member at the absolute
    Gauss times ``gauss_times`` (T, n_nodes), sampled in float64 in one
    ``torch.func.vmap`` pass on ``device``, in ``dtype``."""
    times = torch.as_tensor(gauss_times, device=device)
    params = _tree_map(lambda x: to_tensor(x, device=device), params)
    return torch.movedim(
        torch.func.vmap(lambda p: signals_as_list(p)(times))(params), 0, -1
    ).to(device=device, dtype=dtype)


def _collect_solve(model, yf, traj, y0_cols, want_traj: bool, include_t0: bool, B: int, m: int,
                   vectorized_lindblad: bool):
    """Frame-basis lanes (and trajectory) -> the standard-basis result of
    :func:`fused_sweep_solve`."""
    with span("sweep.collect"):
        if want_traj:
            pieces = []
            if include_t0:
                pieces.append(y0_cols.to(yf.dtype)[None])
            if traj is not None:
                pieces.append(traj)
            return _collect_trajectory(model, torch.cat(pieces, dim=0), B, m, vectorized_lindblad)
        if vectorized_lindblad:
            n = model.dim
            rho = yf[:, :B].reshape(n, n, B).permute(2, 1, 0)  # (B, n, n)
            return model.rotating_frame.operator_out_of_frame_basis(rho)
        return _collect_lanes(model, yf, B, m)


def _adaptive_df_grid(
    signals_as_list, params, static_fb, ops_fb, omega, t0, tf, magnus_order, tol, probes=None,
):
    """Host float64 adaptive step grid of the df32 path (as in the JAX package).

    Greedy step-doubling walk of probe members (default: first, middle and
    last; for amplitude sweeps the stiffest member is an end point): per
    trial step the Magnus propagator over ``[t, t + dt]`` (scipy ``expm``) is
    compared with two half steps, the tolerance spread per unit time
    (``tol * dt / span``). The merged grid takes the pointwise smallest step
    over the probes. Cost: O(grid x probes) host ``expm`` of the solve
    dimension.
    """
    from scipy.linalg import expm

    from ..ops.df_sweep import magnus_operator

    nodes = MAGNUS_NODES[magnus_order]
    static_t, ops_t = (torch.as_tensor(to_numpy(x), dtype=torch.complex128)
                       for x in (static_fb, ops_fb))
    omega_t = torch.as_tensor(to_numpy(omega), dtype=torch.float64)
    leaves = list(_leaves(params))
    B = int(leaves[0].shape[0]) if leaves else 1
    if probes is None:
        probes = sorted({0, B // 2, B - 1})
    span = tf - t0

    def magnus_m(sig, t, dt):
        taus = t + nodes * dt
        coef = np.stack([np.atleast_1d(to_numpy(sig(tau)).astype(float)) for tau in taus])
        step = np.array(step_constants(magnus_order, dt))
        return magnus_operator(
            static_t, ops_t, omega_t, torch.as_tensor(taus), torch.as_tensor(step),
            torch.as_tensor(coef)[..., None], magnus_order, hermitian=False,
        )[0].numpy()

    p = 2 * magnus_order  # local error ~ dt^(p+1); tol_step ~ dt cancels one

    def walk(sig):
        t, dt, steps = t0, span / 64, []
        for _ in range(200_000):
            if t >= tf - 1e-12 * span:
                return steps
            dt = min(dt, tf - t)
            u1 = expm(magnus_m(sig, t, dt))
            u2 = expm(magnus_m(sig, t + dt / 2, dt / 2)) @ expm(magnus_m(sig, t, dt / 2))
            err = float(np.max(np.abs(u1 - u2)))
            tol_step = tol * dt / span
            if err <= tol_step or dt <= 1e-7 * span:
                steps.append((t, dt))
                t += dt
            factor = 0.85 * (tol_step / max(err, 1e-300)) ** (1.0 / p)
            dt = dt * min(max(factor, 0.3), 3.0)
        raise DynamicsError(
            "df_grid='adaptive' did not converge on a step grid (200k trial steps); the "
            "tolerance may be unreachable for this generator."
        )

    fns = []
    with torch.no_grad():
        for b in probes:
            steps = walk(signals_as_list(_tree_map(lambda x: x[b], params)))
            fns.append((np.array([s[0] for s in steps]), np.array([s[1] for s in steps])))

    def dt_at(t):
        return min(float(np.interp(t, ts, ds)) for ts, ds in fns)

    t, dts = t0, []
    while t < tf - 1e-12 * span:
        d = min(dt_at(t), tf - t)
        dts.append(d)
        t += d
        if len(dts) > 500_000:
            raise DynamicsError("df_grid='adaptive' produced a pathological grid.")
    return np.asarray(dts)


def _df_eval_slots(t_eval, dts, t0: float, tf: float):
    """Fit ``t_eval`` into the df step grid ``t0 + cumsum(dts)``.

    The df32 path takes per-step sizes, so an off-grid evaluation time splits
    the step that contains it (the split only shrinks steps). Points within
    1e-9 relative of an existing edge snap to it instead of making a sliver
    step. Returns ``(dts, eval_slots, include_t0)``: the refined step sizes,
    a per-step tuple of trajectory slots (-1: no store) or ``None``, and
    whether ``t_eval[0]`` is ``t0``.
    """
    dts = np.asarray(dts, dtype=float)
    if t_eval is None:
        return dts, None, False
    te = _checked_t_eval(t_eval, t0, tf)
    include_t0 = te[0] - t0 <= 1e-9 * max(1.0, abs(t0))
    kept = te[1:] if include_t0 else te

    def tol(t):
        return 1e-9 * max(1.0, abs(t))

    edges = t0 + np.cumsum(dts)  # time after step j
    new_dts, slots = [], []
    prev, i = t0, 0
    for e in edges:
        while i < len(kept) and kept[i] < e - tol(e):
            t = float(kept[i])
            if t - prev <= 0.0:
                raise DynamicsError(
                    "t_eval contains points too close together to separate on the step grid "
                    f"(around t={t})."
                )
            new_dts.append(t - prev)
            slots.append(i)
            prev = t
            i += 1
        new_dts.append(float(e) - prev)
        if i < len(kept) and abs(kept[i] - e) <= tol(e):
            slots.append(i)
            i += 1
        else:
            slots.append(-1)
        prev = float(e)
    if i < len(kept):
        raise DynamicsError(
            "t_eval points could not be placed on the step grid; the last "
            f"{len(kept) - i} point(s) fall beyond the final step edge ({edges[-1]})."
        )
    return np.asarray(new_dts), (tuple(slots) if len(kept) else None), bool(include_t0)


def _fused_sweep_solve_df(
    model, signals_as_list, params, dts, static_fb, ops_fb, omega, y0_fb, vectorized_lindblad,
    t0, expm_order, chunk_b, magnus_order, eval_slots, include_t0,
):
    """df32 branch of :func:`fused_sweep_solve`: the coefficient table in
    float64 on the model's device (one vmapped pass at the Gauss times of the
    grid ``dts``), then kernel B8 (the plain version for a CPU model)."""
    from ..ops.df_sweep import sweep_expm_magnus_df

    if torch.is_grad_enabled() and any(
        is_tensor(x) and x.requires_grad for x in _leaves(params)
    ):
        raise DynamicsError(
            'fused_sweep_solve(precision="df32") has no gradient (as in the JAX package); '
            'detach params or use precision="f32".'
        )
    if model.dtype != torch.complex128:
        warnings.warn(
            f"df32 precision requested but the model is stored in {model.dtype}; accuracy is "
            "limited by that representation. Build the model with dtype=torch.complex128.",
            stacklevel=3,
        )
    t_start = t0 + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    gauss_times = t_start[:, None] + dts[:, None] * MAGNUS_NODES[magnus_order][None, :]
    with torch.no_grad():
        with span("sweep.tables"):
            coeffs = _gauss_table(signals_as_list, params, gauss_times, model.device,
                                  torch.float64)
        annotate_call(engine="df32", members=coeffs.shape[-1])
        with span("sweep.lanes"):
            coeffs, y0_cols, B, m = _expand_lanes(coeffs, y0_fb, y0_fb.shape[0], 1)
            y0_cols = y0_cols.to(torch.complex128)
        with span("sweep.engine"):
            out = sweep_expm_magnus_df(
                static_fb, ops_fb, omega, coeffs, y0_cols, dt=dts, t0=t0,
                magnus_order=magnus_order, order=max(expm_order, 12), chunk_b=chunk_b,
                hermitian=_all_anti_hermitian(model), eval_slots=eval_slots,
            )
        yf, traj = out if eval_slots is not None else (out, None)
        return _collect_solve(model, yf, traj, y0_cols, eval_slots is not None or include_t0,
                              include_t0, B, m, vectorized_lindblad)


def _select_engine(sweep_engine: str, magnus_order: int, solve_dim: int, member_ok: bool) -> str:
    """Resolve ``sweep_engine="auto"`` and validate the choice. ``member_ok``:
    a vector initial state without ``t_eval``, which the member kernel needs."""
    if magnus_order == 3:
        # 6th-order rule: the member kernel (n <= 64), the eager engine, or,
        # above solve_dim 128, the polynomial engine. At small dims with many
        # steps the polynomial engine's float32 monomial contraction rounds
        # worse than the generator build, so member/eager keep those.
        if sweep_engine == "auto":
            if solve_dim > 128:
                sweep_engine = "poly"
            else:
                sweep_engine = "member" if (solve_dim <= 64 and member_ok) else "xla"
        if sweep_engine == "pallas":
            raise DynamicsError(
                "magnus_order=3 is not implemented in the batch-on-lanes kernel; use "
                "sweep_engine='member', 'xla' or 'auto'."
            )
        if sweep_engine == "member" and solve_dim > 64:
            raise DynamicsError(
                "magnus_order=3 on the member engine needs solve_dim <= 64; use "
                "sweep_engine='xla'."
            )
    if sweep_engine == "auto":
        if solve_dim > 128:
            sweep_engine = "poly"
        elif solve_dim <= 32:
            sweep_engine = "pallas"
        else:
            sweep_engine = "member" if member_ok else "xla"
    if sweep_engine not in ("pallas", "xla", "member", "poly"):
        raise DynamicsError(
            f"unknown sweep_engine {sweep_engine!r}; use 'pallas', 'xla', 'member', 'poly' or "
            "'auto'."
        )
    if sweep_engine == "member" and not member_ok:
        raise DynamicsError(
            "sweep_engine='member' supports vector initial states without t_eval "
            "trajectories; use sweep_engine='xla' for those."
        )
    return sweep_engine


def _fixed_eval_slots(t_eval, t0: float, tf: float, dt: float, n_steps: int):
    """On-grid ``t_eval`` -> (per-step trajectory slots or None, whether t0
    is included)."""
    if t_eval is None:
        return None, False
    te = _checked_t_eval(t_eval, t0, tf)
    s = (te - t0) / dt
    s_round = np.round(s).astype(int)
    if np.any(np.abs(s - s_round) > 1e-6 * np.maximum(1.0, np.abs(s))):
        raise DynamicsError(
            "t_eval points must lie on the fixed step grid t0 + j*dt "
            f"(dt={dt}); off-grid trajectory output is not supported by "
            "the fused kernel."
        )
    if len(np.unique(s_round)) != len(s_round):
        raise DynamicsError(
            "t_eval contains points that map to the same fixed step "
            f"(dt={dt}); remove the duplicates."
        )
    include_t0 = bool(s_round[0] == 0)
    kept_steps = s_round[1:] if include_t0 else s_round
    slots = np.full(n_steps, -1, dtype=int)
    for j, st in enumerate(kept_steps):
        slots[st - 1] = j
    return (tuple(int(x) for x in slots) if len(kept_steps) else None), include_t0


def fused_adaptive_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    atol: float = 1e-6,
    rtol: float = 1e-6,
    max_steps: int = 4096,
    h0: float = 1e-2,
    tile_b: int = 512,
    rwa_signal_map: Optional[Callable] = None,
    envelope_resolution: Optional[int] = None,
    bucket_lanes: bool = True,
    t_eval=None,
    differentiable: bool = True,
    mesh=None,
):
    r"""Lockstep-adaptive dopri5 sweep solve through the fused kernel.

    Args:
        model: a dense ``HamiltonianModel``/``GeneratorModel``. Its device
            decides the engine: the CUDA kernel for a CUDA model, the eager
            twin for a CPU model.
        signals_fn: one member's parameters -> the model's signal list
            (before ``rwa_signal_map``). It is called under
            ``torch.func.vmap`` over axis 0 of ``params``, so envelopes must
            be tensor arithmetic (no ``.item()``, numpy conversion or Python
            branching on tensor values).
        params: a tensor (or nested tuple/list/dict of tensors) with the
            sweep on axis 0.
        t_span: ``(t0, tf)``.
        y0: shared initial state, (dim,) or (dim, m) (e.g. the identity).
        atol/rtol/max_steps/h0/tile_b: kernel controls (see
            :func:`~qiskit_dynamics_tpu_torch.ops.adaptive_sweep.sweep_dopri5_lockstep`).
        rwa_signal_map: maps signals_fn's output to the model's signals.
        envelope_resolution: ``None`` for constant envelopes
            (``E_jb = envelope * e^{i phase}``), or ``S`` for a
            piecewise-constant table of ``S`` midpoint samples over
            ``[t0, tf]``.
        bucket_lanes: sort members by total drive magnitude before tiling
            (each tile shares one step control); results are un-permuted.
        t_eval: strictly increasing times in ``t_span``; switches the return
            to ``(B, len(t_eval), ...)`` trajectories.
        differentiable: the JAX package's default gradient path. Gradients
            are not ported yet: with ``differentiable=True`` and any input
            tensor requiring grad this raises ``NotImplementedError`` rather
            than returning a tensor that silently has no gradient.
        mesh: multi-device sharding; not ported yet (raises).

    Returns:
        (B, dim) complex final states at ``t_span[1]`` (standard basis), or
        (B, dim, m) for a 2d ``y0``; with ``t_eval``, ``(B, n_eval, dim[, m])``.

    On the card, the device work of a call (tables, bucketing, lanes, the
    kernel, the collector) is one CUDA graph per call shape, captured at the
    first call and replayed by the next ones that share its key
    (:func:`_graph_key`: ``signals_fn`` and the map by identity, the shapes
    of ``params``, the model's tensors by identity and version, the options,
    the carriers and phases); every call still reads members 0 and -1 back
    and checks their signals on the host, and a carrier or phase other than
    the graph's is a new capture. The graph bakes in every other value that
    ``signals_fn`` closes over and does not take from ``params``, such as a
    Python number or host tensor inside an envelope: as under the JAX
    package's ``jit``, a change of such a value is not seen (pass it in
    ``params``). The graph is not taken for carriers or phases that are not
    host constants, or for a chain whose capture raises (one that
    synchronizes).
    """
    if mesh is not None:
        raise NotImplementedError(
            "fused_adaptive_sweep_solve(mesh=...) waits for ROADMAP A13 (multi-device, "
            "torch.distributed)."
        )
    if differentiable and any(is_tensor(x) and x.requires_grad for x in _leaves((params, y0))):
        raise NotImplementedError(
            "the gradient of fused_adaptive_sweep_solve (recorded-grid replay) waits for "
            "ROADMAP A5; detach the inputs or pass differentiable=False."
        )
    if min(atol, rtol) < 3e-8:
        warnings.warn(
            "fused_adaptive_sweep_solve runs its state in float32: atol/rtol below ~3e-8 "
            "only spend steps on roundoff-dominated error estimates.",
            stacklevel=2,
        )
    options = dict(atol=atol, rtol=rtol, max_steps=max_steps, h0=h0, tile_b=tile_b,
                   rwa_signal_map=rwa_signal_map, envelope_resolution=envelope_resolution,
                   bucket_lanes=bucket_lanes, t_eval=t_eval)
    with torch.no_grad():
        if model.device.type == "cuda" and _dense_generator(model):
            return _graph_solve(model, signals_fn, params, t_span, y0, options)
        return _solve_eagerly(_AdaptivePlan(model, signals_fn, params, t_span, y0, **options),
                              params)


def sweep_arguments(
    model, signals_fn, params, t_span, y0, atol, rtol, max_steps, h0, tile_b,
    rwa_signal_map, envelope_resolution, bucket_lanes, t_eval,
):
    """The glue of :func:`fused_adaptive_sweep_solve` around its kernel call.

    Returns ``(args, kwargs, collect)``: the arguments of
    :func:`~qiskit_dynamics_tpu_torch.ops.adaptive_sweep.sweep_dopri5_lockstep`
    for the whole batch (amplitude tables, bucketed and mapped onto lanes)
    and the function that maps the kernel's output back to
    ``(B, dim[, m])`` / ``(B, n_eval, dim[, m])`` in member order.
    """
    plan = _AdaptivePlan(
        model, signals_fn, params, t_span, y0, atol=atol, rtol=rtol, max_steps=max_steps, h0=h0,
        tile_b=tile_b, rwa_signal_map=rwa_signal_map, envelope_resolution=envelope_resolution,
        bucket_lanes=bucket_lanes, t_eval=t_eval,
    )
    return plan.arguments(params)


def _solve_eagerly(plan, params):
    """The plan's device chain run once, with no graph: the CPU path, a
    fallback, and a miss before its capture."""
    members = len(next(_leaves(params)))
    annotate_call(engine="adaptive", members=members)
    plan.prepare(members)
    return plan.run(params)


def _dense_generator(model) -> bool:
    """Whether ``model`` is a dense generator model (not a Lindblad one):
    the models the adaptive sweep takes."""
    return (isinstance(model, GeneratorModel)
            and isinstance(model._operator_collection, OperatorCollection)
            and model._operator_collection.operators is not None)


def _flat_signals(signals_fn, rwa_signal_map):
    def flat_signals(p):
        sigs = signals_fn(p)
        if rwa_signal_map is not None:
            sigs = rwa_signal_map(sigs)
        return list(sigs)

    return flat_signals


def _member_ends(params):
    """Members 0 and -1 of ``params`` on the host: one readback a leaf."""
    return _tree_map(lambda x: torch.stack((x[0], x[-1])).cpu(), _tree_map(to_tensor, params))


def _probe_carriers(flat_signals, ends, k: int):
    """The per-call checks of the carriers, on the host: the signals of
    members 0 and -1 (``ends``, from :func:`_member_ends`) built there,
    ``k`` of them, each (summed) signal with one carrier, the same at both
    ends. Returns the angular carriers and member 0's signals."""

    # a mapped signal may be a SignalSum whose terms share one carrier
    def carriers(member):
        sigs = flat_signals(_tree_map(lambda x: x[member], ends))
        if len(sigs) != k:
            raise DynamicsError(
                f"signals_fn (after any rwa_signal_map) must produce {k} signals to "
                f"match the model's operators; got {len(sigs)}."
            )
        each = [np.atleast_1d(to_numpy(s.carrier_freq).astype(float)) for s in sigs]
        firsts = [np.full(carrier.shape, carrier[0]) for carrier in each]
        if each and not np.allclose(np.concatenate(each), np.concatenate(firsts)):
            raise DynamicsError(
                "fused_adaptive_sweep_solve requires each (summed) signal to have "
                "a single carrier frequency."
            )
        return 2 * np.pi * np.asarray([carrier[0] for carrier in each]), sigs

    freqs, sigs = carriers(0)
    freqs_last, _ = carriers(1)
    if not np.allclose(freqs, freqs_last):
        raise DynamicsError(
            "fused_adaptive_sweep_solve does not support sweeping the carrier "
            "frequency — carriers must be the same for every sweep member."
        )
    return freqs, sigs


def _probe_envelopes(sigs, t0: float, tf: float):
    """Reject non-constant envelopes (silently wrong with
    ``envelope_resolution=None``): member 0's, from :func:`_probe_carriers`,
    at a few interior times, on the host."""
    probe_ts = torch.as_tensor(t0 + np.array([0.0, 0.37, 0.71]) * (tf - t0))
    vals = np.asarray(
        [[np.sum(np.atleast_1d(to_numpy(s.envelope(t)).astype(complex))) for t in probe_ts]
         for s in sigs], dtype=complex,
    ).reshape(len(sigs), len(probe_ts))
    if not np.allclose(vals, vals[:, :1], rtol=1e-12, atol=1e-12):
        raise DynamicsError(
            "fused_adaptive_sweep_solve with envelope_resolution=None requires "
            "constant-envelope signals; pass envelope_resolution=S for "
            "time-dependent pulse shapes."
        )


class _AdaptivePlan:
    """What the adaptive sweep's glue fixes for one call shape on the host
    (the checked carriers, the amplitude tables' device constants, ``y0``
    in the frame basis, the evaluation times, B1's static planes) and the
    device chain from the parameters to the result (:meth:`run`)."""

    def __init__(self, model, signals_fn, params, t_span, y0, atol, rtol, max_steps, h0, tile_b,
                 rwa_signal_map, envelope_resolution, bucket_lanes, t_eval, probe=None):
        (vectorized_lindblad, self.solve_dim, self.static_fb, self.ops_fb, self.omega, t0,
         tf) = _extract_generator_data(model, t_span, "fused_adaptive_sweep_solve")
        if vectorized_lindblad:
            raise NotImplementedError(
                "fused_adaptive_sweep_solve on a vectorized LindbladModel is still to be ported "
                "(ROADMAP A7, left over); use fused_sweep_solve."
            )
        self.model, self.device = model, model.device
        self.flat_signals = _flat_signals(signals_fn, rwa_signal_map)
        self.envelope_resolution, self.bucket_lanes, self.tile_b = (
            envelope_resolution, bucket_lanes, tile_b)
        with span("sweep.tables"):
            if probe is None:
                probe = _probe_carriers(self.flat_signals, _member_ends(params),
                                        self.ops_fb.shape[0])
            self.freqs, probe_sigs = probe
            if envelope_resolution is None:
                _probe_envelopes(probe_sigs, t0, tf)
                self.t_zero = torch.zeros((), dtype=torch.float64, device=self.device)
                env_dt = 0.0
            else:
                n_env = int(envelope_resolution)
                env_dt = (tf - t0) / n_env
                env_times_np = t0 + (np.arange(n_env) + 0.5) * env_dt
                self.env_times = torch.as_tensor(env_times_np, device=self.device)
                self.carrier_phase = torch.as_tensor(
                    np.exp(-1j * self.freqs[:, None] * env_times_np[None, :]), device=self.device
                )  # (k, S)
        with span("sweep.lanes"):
            self.y0_fb = model.rotating_frame.state_into_frame_basis(y0)
            eval_ts, self.include_t0 = _eval_times(t_eval, t0, tf)
        self.want_traj = t_eval is not None
        self.kwargs = dict(tf=tf, t0=t0, atol=atol, rtol=rtol, max_steps=max_steps, h0=h0,
                           tile_b=tile_b, env_dt=env_dt, eval_ts=eval_ts)
        # per signal whose carrier and phase are host tensors in member 0's
        # probe: those tensors and their device factor, uploaded here so that
        # the device chain uploads nothing
        self.factors = {}
        for j, sig in enumerate(probe_sigs):
            if sig.carrier_freq.device.type != "cpu" or sig.phase.device.type != "cpu":
                continue
            if envelope_resolution is None:
                factor = self._phase_factor(sig)
            elif type(sig).complex_value is Signal.complex_value:
                factor = sig.carrier_factor(self.env_times)
            else:
                continue
            self.factors[j] = (sig.carrier_freq, sig.phase, factor)
        self.host_constants = True  # every factor of the chain came from self.factors
        self.inputs = None  # B1's static planes (prepare)

    def _phase_factor(self, sig):
        return torch.exp(1j * sig.phase.to(self.device).reshape(-1))

    def _factor(self, j: int, sig, make):
        """Signal ``j``'s held factor where its carrier and phase are the host
        tensors it was made from, else ``make()`` (and no graph)."""
        held = self.factors.get(j)
        if (held is not None and sig.carrier_freq.device.type == "cpu"
                and sig.phase.device.type == "cpu" and torch.equal(sig.carrier_freq, held[0])
                and torch.equal(sig.phase, held[1])):
            return held[2]
        self.host_constants = False
        return make()

    def _amplitudes(self, p):
        rows = []
        for j, s in enumerate(self.flat_signals(p)):
            if self.envelope_resolution is None:
                env = to_tensor(s.envelope(self.t_zero)).to(torch.complex128).reshape(-1)
                factor = self._factor(j, s, lambda s=s: self._phase_factor(s))
                rows.append(torch.sum(env * factor))  # E_jb = envelope * e^{i phase}
                continue
            if type(s).complex_value is Signal.complex_value:
                factor = self._factor(j, s, lambda s=s: s.carrier_factor(self.env_times))
                value = s.modulate(self.env_times, factor)
            else:
                self.host_constants = False
                value = s.complex_value(self.env_times)
            rows.append(value.to(torch.complex128) * self.carrier_phase[j])
        return torch.stack(rows)  # (k,) or (k, S)

    def tables(self, params) -> torch.Tensor:
        """(k, B) constant amplitudes or (k, S, B) envelope tables for the
        whole batch, in one ``torch.func.vmap`` pass over ``signals_fn``."""
        params = _tree_map(lambda x: to_tensor(x, device=self.device), params)
        return torch.movedim(torch.func.vmap(self._amplitudes)(params), 0, -1).to(self.device)

    def lanes(self, amps):
        """Stiffness bucketing (each tile shares one step control, so members
        of similar drive magnitude go to the same tile: a pure permutation),
        then the members onto lanes."""
        inv_order = None
        if self.bucket_lanes:
            key = torch.sum(torch.abs(amps), dim=tuple(range(amps.ndim - 1)))  # (B,)
            order = torch.argsort(key, stable=True)
            inv_order = torch.argsort(order)
            amps = amps[..., order]
        amps, y0_cols, B, m = _expand_lanes(amps, self.y0_fb, self.solve_dim, self.tile_b)
        return amps, y0_cols, B, m, inv_order

    def collect(self, out_kernel, y0_cols, B: int, m: int, inv_order):
        """The kernel's output back to ``(B, dim[, m])`` / ``(B, n_eval,
        dim[, m])`` in member order."""
        if self.want_traj:
            yf, traj = out_kernel if self.kwargs["eval_ts"] is not None else (out_kernel, None)
            pieces = []
            if self.include_t0:
                pieces.append(y0_cols.to(yf.dtype)[None])
            if traj is not None:
                pieces.append(traj)
            out = _collect_trajectory(self.model, torch.cat(pieces, dim=0), B, m)
        else:
            out = _collect_lanes(self.model, out_kernel, B, m)
        return out if inv_order is None else out[inv_order]

    def arguments(self, params):
        """``(args, kwargs, collect)`` of :func:`sweep_arguments`."""
        with span("sweep.tables"):
            amps = self.tables(params)
        with span("sweep.lanes"):
            amps, y0_cols, B, m, inv_order = self.lanes(amps)
        annotate_call(engine="adaptive", members=B)
        args = (self.static_fb, self.ops_fb, self.omega, self.freqs, amps, y0_cols)

        def collect(out_kernel):
            with span("sweep.collect"):
                return self.collect(out_kernel, y0_cols, B, m, inv_order)

        return args, dict(self.kwargs), collect

    def prepare(self, members: int):
        """B1's planes of everything but the amplitudes, for ``members``
        members (uploads the carriers and evaluation times)."""
        from ..ops.adaptive_sweep import prepare_static_inputs

        self.members = members
        with span("sweep.prepare"):
            y0_cols = _lane_states(self.y0_fb, self.solve_dim, members, self.tile_b)
            self.inputs = prepare_static_inputs(
                self.static_fb, self.ops_fb, self.omega, self.freqs, y0_cols,
                table=self.envelope_resolution is not None, **self.kwargs,
            )

    def run(self, params, span=span):
        """The device chain from ``params`` to the result on the prepared
        planes: tables, lanes, B1 and the collector, with no readback, no
        upload and no allocation whose size depends on values (so that a
        CUDA graph can hold it)."""
        from ..ops.adaptive_sweep import sweep_prepared, with_envelopes

        with span("sweep.tables"):
            amps = self.tables(params)
        with span("sweep.lanes"):
            amps, y0_cols, B, m, inv_order = self.lanes(amps)
        with span("sweep.prepare"):
            inputs = with_envelopes(self.inputs, amps)
        with span("sweep.engine", tile_b=inputs.tile_b, lanes=inputs.batch):
            final, traj, _ = sweep_prepared(inputs)
        with span("sweep.collect"):
            return self.collect(final if traj is None else (final, traj), y0_cols, B, m,
                                inv_order)


def _no_span(name, **attrs):
    return contextlib.nullcontext()


class _SweepGraph:
    """One call shape's device chain (:meth:`_AdaptivePlan.run`) as a CUDA
    graph. :meth:`replay` copies the parameters into the graph's own input,
    replays it and returns a copy of its output (callers keep results across
    calls). A capture launches nothing: the kernels run at each replay, which
    counts B1's launch as the boundary counts an eager one."""

    def __init__(self, plan: _AdaptivePlan, params, refs):
        self.plan, self.refs = plan, refs  # refs: what the key names by identity
        self.params = _tree_map(lambda x: x.detach().clone(), params)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = plan.run(self.params, span=_no_span)
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()  # the last replay's output copied

    def replay(self, params) -> torch.Tensor:
        with self.lock:
            stream = torch.cuda.current_stream(self.out.device)
            stream.wait_event(self.done)
            for dst, src in zip(_leaves(self.params), _leaves(params)):
                dst.copy_(src)
            self.graph.replay()
            out = self.out.clone()
            self.done.record(stream)
        metrics.count("kernel.launches.adaptive_sweep_launch", always=True)
        return out


class _Eager:
    """The entry of a key whose chain no graph holds (its carriers or phases
    are not host constants, or its capture raised, as where the chain
    synchronizes)."""

    def __init__(self, refs):
        self.refs = refs


_GRAPHS: OrderedDict = OrderedDict()  # graph key -> _SweepGraph or _Eager


def _structure(tree):
    """The nesting, shapes, dtypes and devices of a tree of tensors, hashable."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((key, _structure(val)) for key, val in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_structure(val) for val in tree)
    return (tuple(tree.shape), tree.dtype, tree.device)


def _graph_refs(model, signals_fn, y0, options) -> tuple:
    """What :func:`_graph_key` names by identity: an entry holds them, so that
    their ids are not reused while it lives."""
    coll, frame = model._operator_collection, model.rotating_frame
    return (signals_fn, options["rwa_signal_map"], coll.static_operator, coll.operators,
            frame.frame_diag, frame.frame_basis, y0)


def _graph_key(model, signals_fn, params, t_span, y0, options, baked, counting: bool) -> tuple:
    """The key of a call's CUDA graph: every input the device chain reads or
    bakes in. ``signals_fn`` and ``rwa_signal_map`` by identity; ``params``
    by structure, shapes, dtypes and device (their values are copied in);
    the model's operators, frame and ``y0`` by identity and in-place version
    (by value where not a tensor); the options; ``counting``, whether B1
    adds its steps into the metrics' device counters (their pointer is baked
    into the graph); last, ``baked``, the carriers and phases that the host
    probe found (:func:`_baked`; ``None``: the key without them)."""

    def operand(x):
        return None if x is None else lru.operand_key(x)

    coll, frame = model._operator_collection, model.rotating_frame
    t_eval = options["t_eval"]
    return (
        id(signals_fn), id(options["rwa_signal_map"]), _structure(params),
        model.device, model.dtype, operand(coll.static_operator), operand(coll.operators),
        operand(frame.frame_diag), operand(frame.frame_basis), operand(y0),
        float(t_span[0]), float(t_span[-1]), float(options["atol"]), float(options["rtol"]),
        int(options["max_steps"]), float(options["h0"]), int(options["tile_b"]),
        options["envelope_resolution"], bool(options["bucket_lanes"]),
        None if t_eval is None else tuple(np.atleast_1d(to_numpy(t_eval)).astype(float)),
        bool(counting), baked,
    )


def _baked(probe) -> tuple:
    """What a graph bakes in of the signals, from the host probe
    (:func:`_probe_carriers`): the angular carriers and member 0's phases.
    A phase that changes with the parameters is no host constant in the
    chain, and no graph holds it."""
    freqs, sigs = probe
    return (tuple(float(f) for f in freqs),
            tuple(tuple(np.ravel(to_numpy(s.phase)).astype(float).tolist()) for s in sigs))


def _latest_entry(base: tuple):
    """The most recently used entry of :data:`_GRAPHS` whose key is ``base``
    and any baked carriers and phases, as ``(baked, entry)``, or ``None``."""
    with lru.LOCK:
        for key in reversed(_GRAPHS):
            if key[:-1] == base:
                _GRAPHS.move_to_end(key)
                return key[-1], _GRAPHS[key]
    return None


def _graph_solve(model, signals_fn, params, t_span, y0, options):
    """:func:`fused_adaptive_sweep_solve` on the card.

    Members 0 and -1 are read back first. A hit replays the graph of the
    key's latest entry, then checks the signals on the host while the card
    runs it (an error discards the result) and keeps the result if the
    carriers and phases are the entry's. Otherwise the call runs the chain
    eagerly and, at a key's first call, captures it (a miss). A key whose
    chain no graph holds runs the eager path (a fallback). Counted as
    ``sweep.graph_hits``, ``_misses``, ``_fallbacks``.
    """
    from ..ops.adaptive_sweep import STEP_COUNTERS

    t0, tf = _time_span(t_span, "fused_adaptive_sweep_solve")
    params = _tree_map(lambda x: to_tensor(x, device=model.device), params)
    flat_signals = _flat_signals(signals_fn, options["rwa_signal_map"])
    k = model._operator_collection.operators.shape[0]
    with span("sweep.tables"):
        ends = _member_ends(params)  # before any replay, which it would wait for
    counting = metrics.device_counters(STEP_COUNTERS, model.device) is not None
    base = _graph_key(model, signals_fn, params, t_span, y0, options, None, counting)[:-1]
    latest = _latest_entry(base)
    if latest is not None and isinstance(latest[1], _SweepGraph):
        graph = latest[1]
        annotate_call(engine="adaptive", members=graph.plan.members)
        with span("sweep.engine", tile_b=graph.plan.tile_b, lanes=graph.plan.inputs.batch):
            out = graph.replay(params)
        with span("sweep.tables"):
            probe = _probe_carriers(flat_signals, ends, k)
            if options["envelope_resolution"] is None:
                _probe_envelopes(probe[1], t0, tf)
        if _baked(probe) == latest[0]:
            metrics.count("sweep.graph_hits")
            return out
    else:
        with span("sweep.tables"):
            probe = _probe_carriers(flat_signals, ends, k)
    plan = _AdaptivePlan(model, signals_fn, params, t_span, y0, probe=probe, **options)
    key = base + (_baked(probe),)
    if latest is not None and isinstance(latest[1], _Eager) and key[-1] == latest[0]:
        metrics.count("sweep.graph_fallbacks")
        return _solve_eagerly(plan, params)
    out = _solve_eagerly(plan, params)
    refs = _graph_refs(model, signals_fn, y0, options)
    entry = _Eager(refs)
    if plan.host_constants:
        try:
            entry = _SweepGraph(plan, params, refs)
        except RuntimeError:
            pass
    metrics.count("sweep.graph_misses" if isinstance(entry, _SweepGraph)
                  else "sweep.graph_fallbacks")
    lru.put(_GRAPHS, key, entry)
    return out


def _checked_t_eval(t_eval, t0: float, tf: float) -> np.ndarray:
    """``t_eval`` as a float64 array, checked: non-empty, 1d, strictly
    increasing, within ``[t0, tf]`` (with a 1e-9 slack)."""
    te = np.atleast_1d(to_numpy(t_eval).astype(float))
    if te.ndim != 1 or te.size == 0:
        raise DynamicsError("t_eval must be a non-empty 1d sequence of times.")
    if te.size > 1 and np.any(np.diff(te) <= 0):
        raise DynamicsError("t_eval must be strictly increasing.")
    if te[0] < t0 - 1e-9 or te[-1] > tf + 1e-9 * max(1.0, abs(tf)):
        raise DynamicsError(f"t_eval must lie within t_span ({t0}, {tf}).")
    return te


def _eval_times(t_eval, t0: float, tf: float):
    """``t_eval`` -> (elapsed kernel eval times or None, whether t0 is included)."""
    if t_eval is None:
        return None, False
    te = _checked_t_eval(t_eval, t0, tf)
    # snap tolerance covers the containment slack above: a te[0] in
    # [t0 - 1e-9, t0) would otherwise produce a negative elapsed time
    include_t0 = te[0] - t0 <= 1e-9 * max(1.0, abs(t0))
    rel = (te[1:] if include_t0 else te) - t0
    return (tuple(float(x) for x in rel) if rel.size else None), include_t0


def _expand_lanes(lane_data: torch.Tensor, y0_fb: torch.Tensor, dim: int, tile_b: int):
    """Map sweep members x y0 columns onto kernel lanes.

    1d ``y0_fb`` (dim,): one lane per sweep member. 2d ``y0_fb`` (dim, m) —
    e.g. the identity for unitary sweeps: each member occupies ``m``
    consecutive lanes (per-lane data repeated, y0 columns tiled). Pads the
    lane axis to a multiple of ``tile_b`` with copies of the first lane, so
    the tile-wide error max never reads garbage. Returns
    (lane_data, y0_cols, B, m).
    """
    m = 1 if y0_fb.ndim == 1 else y0_fb.shape[1]
    B = lane_data.shape[-1]
    if m > 1:
        lane_data = torch.repeat_interleave(lane_data, m, dim=-1)
    pad = (-B * m) % tile_b
    if pad:
        filler = lane_data[..., :1].expand(lane_data.shape[:-1] + (pad,))
        lane_data = torch.cat([lane_data, filler], dim=-1)
    return lane_data, _lane_states(y0_fb, dim, B, tile_b), B, m


def _lane_states(y0_fb: torch.Tensor, dim: int, B: int, tile_b: int) -> torch.Tensor:
    """The initial states of :func:`_expand_lanes`'s lanes for ``B`` members."""
    m = 1 if y0_fb.ndim == 1 else y0_fb.shape[1]
    pad = (-B * m) % tile_b
    if m == 1:
        return y0_fb[:, None].expand(dim, B + pad)
    cols = y0_fb.repeat(1, B)  # member-major, column-minor
    return torch.cat([cols, cols[:, :1].expand(dim, pad)], dim=-1)


def _collect_lanes(model, yf: torch.Tensor, B: int, m: int) -> torch.Tensor:
    """Inverse of :func:`_expand_lanes`: (dim, lanes) -> (B, dim) or (B, dim, m)."""
    yf = model.rotating_frame.state_out_of_frame_basis(yf[:, : B * m])
    if m == 1:
        return yf.T
    return torch.movedim(yf.reshape(yf.shape[0], B, m), 1, 0)


def _collect_trajectory(
    model, traj: torch.Tensor, B: int, m: int, vectorized_lindblad: bool = False
) -> torch.Tensor:
    """(n_eval, dim, lanes) frame-basis trajectory -> (B, n_eval, dim),
    (B, n_eval, dim, m), or (B, n_eval, n, n) density matrices for a
    vectorized Lindblad model."""
    if vectorized_lindblad:
        n = model.dim
        rho = traj[:, :, :B].reshape(-1, n, n, B).permute(3, 0, 2, 1)
        return model.rotating_frame.operator_out_of_frame_basis(rho)
    traj = model.rotating_frame.state_out_of_frame_basis(traj[:, :, : B * m])
    if m == 1:
        return traj.permute(2, 0, 1)
    n_eval, dim = traj.shape[0], traj.shape[1]
    return torch.movedim(traj.reshape(n_eval, dim, B, m), 2, 0)
