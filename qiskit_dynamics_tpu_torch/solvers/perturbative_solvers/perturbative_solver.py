r"""Dyson/Magnus perturbative solvers (Dysolve-style fast stepping).

Counterpart of
``qiskit_dynamics_tpu/solvers/perturbative_solvers/perturbative_solver.py``.

Both solvers precompute an :class:`ExpansionModel` at construction, then solve
by per-step polynomial evaluation. ``solve`` has two stepping routes: a host
loop in complex128 numpy, and a batched route that builds every step's
propagator with one polynomial evaluation (and one batched ``expm`` for
Magnus) on the model's device and composes them with a log-depth scan.
``solve_sweep`` runs a whole parameter sweep through the batch-minor kernels:
the streamed propagator chain, and for Magnus the batched Taylor ``expm``;
with ``precision="df32"`` in complex128, native FP64 in place of the JAX
package's double-float32 Dysolve (``ops/df_chain.py``, whose term split and
kernel cache are not carried).

``solve_sweep`` records the sweep path's spans (``utils/metrics.py``):
``sweep.call`` (attrs ``method``, ``engine="perturbative"``, ``members``)
around ``sweep.tables`` (the Chebyshev coefficients), ``sweep.prepare`` (the
frame maps, ``y0`` and the expansion on the device), one ``sweep.engine`` per
pass over a chunk of members (attrs ``method``, ``n``, ``monomials``,
``lanes``) and ``sweep.collect``; and the host counters ``pert.step_lanes``
(steps x members) and ``pert.monomials`` (the expansion's terms) per pass.
"""
from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Union

import numpy as np
import torch
from scipy.linalg import expm as scipy_expm

from ...exceptions import DynamicsError
from ...ops.batched_linalg import expm_taylor_bol_ad
from ...ops.expm import expm_pade
from ...ops.chain_apply import chain_apply_bol_ad
from ...ops.monomial_contract import Expansion, contract_monomials
from ...parallel.scan import propagator_scan
from ...signals import SignalList
from ...unified import is_tensor, to_numpy, to_tensor
from ...utils import metrics
from ...utils.metrics import annotate_call, count, span
from ..fused_sweep import _leaves, _tree_map
from ..results import OdeResult
from ..solver_utils import setup_args_lists
from .expansion_model import ExpansionModel

__all__ = ["DysonSolver", "MagnusSolver"]

_MAGNUS_EXPM_ORDER = 12  # Taylor order of the per-step expm in solve_sweep


def _nested_ndim(x) -> int:
    if isinstance(x, (list, tuple)):
        return 1 + _nested_ndim(x[0])
    if hasattr(x, "ndim"):
        return x.ndim
    return 0


def _scalar_to_list(x, name):
    ndim = _nested_ndim(x)
    if ndim > 1:
        raise DynamicsError(f"{name} must be either 0d or 1d.")
    if ndim == 1:
        return list(x), True
    return [x], False


def _y0_to_list(y0):
    if isinstance(y0, list):
        return y0, True
    return [y0], False


def _signals_to_list(signals):
    if signals is None:
        return [signals], False
    if isinstance(signals, list) and isinstance(signals[0], (list, SignalList)):
        return signals, True
    if isinstance(signals, SignalList) or (
        isinstance(signals, list) and not isinstance(signals[0], (list, SignalList))
    ):
        return [signals], False
    raise DynamicsError("Signals specified in invalid format.")


def _frame_ends(model, t0, n_steps):
    """The frame maps at both ends of the solve, host complex128:
    ``U0 = exp(t0 F)`` and ``Uf = exp(-(t0 + n_steps dt) F)``."""
    dim = model.Udt.shape[0]
    eye = np.eye(dim, dtype=complex)
    frame = model.rotating_frame
    U0 = to_numpy(frame.state_out_of_frame(t0, eye))
    Uf = to_numpy(frame.state_into_frame(t0 + n_steps * model.dt, eye))
    return U0, Uf


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.complex64 else torch.float64


def _call_span(method: str, members: int):
    """The ``sweep.call`` span of one ``solve_sweep``; where the caller has a
    ``sweep.call`` open already, none: the stages join the caller's call,
    which takes the engine and member count as attrs."""
    if metrics.recording() and any(s.name == "sweep.call" for s in metrics._REC.stack()):
        annotate_call(engine="perturbative", members=members)
        return contextlib.nullcontext()
    return span("sweep.call", method=method, engine="perturbative", members=members)


def _perturbative_solve(single_step: Callable, model, signals, y0, t0, n_steps):
    """Host-loop stepping, complex128 numpy."""
    U0, Uf = _frame_ends(model, t0, n_steps)
    coeffs = to_numpy(model.approximate_signals(signals, t0, n_steps))
    y = U0 @ to_numpy(y0)
    for k in range(n_steps):
        y = single_step(coeffs[:, k], y)
    return Uf @ y


def _perturbative_solve_batched(step_propagators: Callable, model, signals, y0, t0, n_steps):
    """Parallel stepping on the model's device: every step's propagator from
    one batched evaluation, composed by a log-depth cumulative product."""
    U0, Uf = _frame_ends(model, t0, n_steps)
    device, dtype = model.device, model.dtype
    coeffs = model.approximate_signals(signals, t0, n_steps).to(_real_dtype(dtype))
    total = propagator_scan(step_propagators(coeffs))[-1]
    U0 = torch.as_tensor(U0, device=device).to(dtype)
    Uf = torch.as_tensor(Uf, device=device).to(dtype)
    return Uf @ (total @ (U0 @ to_tensor(y0, device=device).to(dtype)))


class _PerturbativeSolver(ABC):
    """Base class: precomputed model + list-broadcasting ``solve``. The
    constructor computes the expansion that ``_expansion_method`` names;
    :meth:`from_model` wraps one that exists."""

    _expansion_method: str

    def __init__(
        self,
        operators,
        rotating_frame,
        dt: float,
        carrier_freqs,
        chebyshev_orders: List[int],
        expansion_order: Optional[int] = None,
        expansion_labels: Optional[List] = None,
        integration_method: Optional[str] = None,
        include_imag: Optional[List[bool]] = None,
        device=None,
        dtype: torch.dtype = torch.complex128,
        **kwargs,
    ):
        self._model = ExpansionModel(
            operators=operators,
            rotating_frame=rotating_frame,
            dt=dt,
            carrier_freqs=carrier_freqs,
            chebyshev_orders=chebyshev_orders,
            expansion_method=self._expansion_method,
            expansion_order=expansion_order,
            expansion_labels=expansion_labels,
            integration_method=integration_method,
            include_imag=include_imag,
            device=device,
            dtype=dtype,
            **kwargs,
        )

    @classmethod
    def from_model(cls, model: ExpansionModel):
        """The solver around a constructed ``model``, nothing recomputed."""
        solver = cls.__new__(cls)
        solver._model = model
        return solver

    @property
    def model(self) -> ExpansionModel:
        """Model object storing expansion details."""
        return self._model

    def solve(
        self,
        t0,
        n_steps,
        y0,
        signals,
        jax_control_flow: Optional[bool] = None,
    ) -> Union[OdeResult, List[OdeResult]]:
        """Solve for initial time(s), step count(s), state(s), and signal list(s).

        Any argument may be a list to run a batch of simulations; lists must
        have matching lengths (non-list args are broadcast).
        ``jax_control_flow`` (the JAX package's name, kept so call sites port
        unchanged) picks the batched route on the model's device; it defaults
        to that route when ``y0`` is a tensor, and to the host loop otherwise.
        """
        if jax_control_flow is None:
            jax_control_flow = is_tensor(y0) or (
                isinstance(y0, list) and any(is_tensor(y) for y in y0)
            )

        args, multiple_sims = setup_args_lists(
            args_list=[t0, n_steps, y0, signals],
            args_names=["t0", "n_steps", "y0", "signals"],
            args_to_list=[
                lambda x: _scalar_to_list(x, "t0"),
                lambda x: _scalar_to_list(x, "n_steps"),
                _y0_to_list,
                _signals_to_list,
            ],
        )

        all_results = []
        for t0_i, n_steps_i, y0_i, signals_i in zip(*args):
            if len(signals_i) != len(self.model.operators):
                raise DynamicsError(
                    "Signals must be the same length as the operators in the model."
                )
            all_results.append(
                self._solve(
                    t0=t0_i,
                    n_steps=n_steps_i,
                    y0=y0_i,
                    signals=signals_i,
                    jax_control_flow=jax_control_flow,
                )
            )
        return all_results if multiple_sims else all_results[0]

    @abstractmethod
    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        ...

    def solve_sweep(
        self,
        t0: float,
        n_steps: int,
        y0,
        signals_fn: Callable,
        params,
        mesh=None,
        expm_squarings: int = 1,
        precision: str = "f32",
        df_order: int = 2,
        df_chunk_b: int = 2048,
        df_devices=None,
    ) -> torch.Tensor:
        """Batched parameter-sweep solve through the streamed chain kernel.

        Evaluates the expansion polynomial for EVERY (step, sweep member)
        with one matrix product; for Magnus additionally exponentiates every
        step with the batch-minor Taylor ``expm`` kernel over the flattened
        ``T * B`` lanes; then applies the per-lane propagator chains with the
        streamed kernel
        (:func:`~qiskit_dynamics_tpu_torch.ops.chain_apply.chain_apply_bol`).
        With ``precision="f32"`` the stepping runs on the card in
        float32/complex64, the kernels' fastest type, and on the CPU (the
        plain versions) in the model's ``dtype``; it is differentiable in
        ``params``. With ``precision="df32"`` it runs in float64/complex128
        everywhere (the complex128 kernels on the card): the JAX package's
        1e-8-class double-float32 Dysolve, in native FP64. Signal sampling is
        float64 either way.

        Args:
            t0: shared initial time.
            n_steps: number of steps of size ``model.dt``.
            y0: shared initial state, shape (dim,).
            signals_fn: maps one parameter tree to a signal list; it is
                evaluated under ``torch.func.vmap``, so envelopes must be
                written with torch functions of tensors.
            params: batched parameters (dim 0 = sweep axis).
            mesh: multi-device sharding; waits for ROADMAP A13 (raises).
            expm_squarings: (Magnus only) scaling-and-squaring count of the
                per-step Taylor-12 ``expm``. In the Dysolve regime the Magnus
                polynomial's norm is well below 1, so Taylor-12 converges
                unscaled and every squaring only amplifies rounding; the
                default 1 keeps a 2x margin on the convergence radius. Raise
                it only for ``||Omega dt|| > 1``.
            precision: ``"f32"`` or ``"df32"`` (native FP64; no gradient:
                ``params`` must not require grad).
            df_order: (df32) the JAX package's double-float32 term split;
                accepted, a no-op (every term is FP64 here).
            df_chunk_b: (df32) sweep members per pass: bounds the (M, T x
                members) float64 monomial table (7.5 GB for 461 monomials,
                1,000 steps and 2,048 members).
            df_devices: (df32) multi-device dispatch; waits for ROADMAP A13.

        Returns:
            (B, dim) final states on the model's device (in the rotating
            frame of the model, like ``solve``); complex128 for ``"df32"``.
        """
        if precision not in ("f32", "df32"):
            raise DynamicsError(f"Unknown precision {precision!r} (use 'f32' or 'df32').")
        if mesh is not None:
            raise NotImplementedError(
                "solve_sweep(mesh=...) waits for ROADMAP A13 (multi-device, torch.distributed)."
            )
        model = self.model
        device = model.device
        if precision == "df32":
            del df_order  # every term is FP64 here
            if df_devices is not None:
                raise NotImplementedError(
                    "solve_sweep(df_devices=...) waits for ROADMAP A13 (multi-device, "
                    "torch.distributed)."
                )
            if torch.is_grad_enabled() and any(
                is_tensor(x) and x.requires_grad for x in _leaves(params)
            ):
                raise DynamicsError(
                    'solve_sweep(precision="df32") has no gradient (as in the JAX package); '
                    'detach params or use precision="f32".'
                )
            if df_chunk_b < 1:
                raise DynamicsError(f"df_chunk_b must be positive; got {df_chunk_b}")
            cdtype = torch.complex128
        else:
            cdtype = torch.complex64 if device.type == "cuda" else model.dtype

        params = _tree_map(lambda x: to_tensor(x, device=device), params)
        with _call_span(model.expansion_method, int(next(_leaves(params)).shape[0])):
            with span("sweep.tables"):
                coeffs = torch.func.vmap(
                    lambda p: model.approximate_signals(signals_fn(p), t0, n_steps)
                )(params)                                    # (B, n_vars, T), float64
                coeffs = torch.movedim(coeffs, 0, -1).to(  # (n_vars, T, B)
                    _real_dtype(cdtype), memory_format=torch.contiguous_format)
            B = coeffs.shape[2]

            with span("sweep.prepare"):
                # the frame maps come from the frame in complex128 and are cast last
                U0, Uf = _frame_ends(model, t0, n_steps)
                y0_frame = torch.as_tensor(
                    U0 @ to_numpy(y0).astype(complex), device=device).to(cdtype)
                Uf = torch.as_tensor(Uf, device=device).to(cdtype)
                expansion = self._sweep_expansion(cdtype)
            chunk = df_chunk_b if precision == "df32" else B
            with torch.no_grad() if precision == "df32" else contextlib.nullcontext():
                finals = [
                    self._sweep_chain(coeffs[:, :, b0:b0 + chunk], y0_frame, expansion,
                                      expm_squarings)
                    for b0 in range(0, B, chunk)
                ]
                with span("sweep.collect"):
                    return torch.cat([(Uf @ final).T for final in finals])

    def _sweep_expansion(self, cdtype):
        """The expansion on the model's device for :meth:`_sweep_chain`, made
        at the first call in ``cdtype`` and kept: an
        :class:`~qiskit_dynamics_tpu_torch.ops.monomial_contract.Expansion`
        (the complex coefficients as ONE real (2 n^2, M) matrix, rows the real
        plane then the imaginary plane; the constant term as the product's
        (2 n^2, 1) starting value, None without one) and Magnus's ``Udt`` in
        ``cdtype`` (None for Dyson)."""
        kept = self.__dict__.setdefault("_sweep_expansions", {})
        if cdtype in kept:
            return kept[cdtype]
        model = self.model
        device = model.device
        dim = model.Udt.shape[0]
        polynomial = model.expansion_polynomial
        array_coeffs, constant = polynomial.tensors(device, cdtype)
        n_terms = array_coeffs.shape[0]
        planes = torch.view_as_real(array_coeffs.reshape(n_terms, dim * dim))
        planes = planes.permute(2, 1, 0).reshape(2 * dim * dim, n_terms)
        start = None
        if constant is not None:
            start = torch.view_as_real(constant.reshape(dim * dim)).T.reshape(-1, 1)
        Udt = None
        if model.expansion_method == "magnus":
            Udt = torch.as_tensor(model.Udt, device=device).to(cdtype)
        kept[cdtype] = (Expansion(polynomial, planes, start, dim), Udt)
        return kept[cdtype]

    def _sweep_chain(self, coeffs, y0_frame, expansion, expm_squarings: int):
        """The frame-basis final states (dim, B) of the members of ``coeffs``
        (n_vars, T, B): the ``expansion`` of :meth:`_sweep_expansion` at every
        step (the monomials and their contraction,
        :func:`~qiskit_dynamics_tpu_torch.ops.monomial_contract.contract_monomials`),
        the per-step ``expm`` for Magnus, the streamed chain."""
        model = self.model
        contraction, Udt = expansion
        dim = model.Udt.shape[0]
        n_terms = contraction.planes.shape[1]
        T_steps, B = coeffs.shape[1], coeffs.shape[2]
        method = model.expansion_method
        count("pert.step_lanes", T_steps * B)
        count("pert.monomials", n_terms)
        with span("sweep.engine", method=method, n=dim, monomials=n_terms,
                  lanes=T_steps * B):
            lanes = contract_monomials(coeffs.reshape(coeffs.shape[0], T_steps * B), contraction,
                                       interleaved=method == "dyson")
            if method == "magnus":
                # per-step propagator = Udt @ expm(polynomial), exponentiated over
                # the flattened (T * B) lanes, kernel forward and kernel backward
                exp_r, exp_i = expm_taylor_bol_ad(
                    lanes[0], lanes[1], _MAGNUS_EXPM_ORDER, expm_squarings
                )
                del lanes
                props = (Udt @ torch.complex(exp_r, exp_i).reshape(dim, -1)).reshape(
                    dim, dim, T_steps, B
                )
            else:
                props = lanes.reshape(dim, dim, T_steps, B)
            props = torch.movedim(props, 2, 0)               # (T, n, n, B), a view
            return chain_apply_bol_ad(props, y0_frame[:, None].expand(dim, B))


class DysonSolver(_PerturbativeSolver):
    r"""Fixed-step LMDE solver via a precompiled truncated Dyson series.

    For generators :math:`G(t) = G_0 + \sum_j Re[f_j(t)e^{i2\pi\nu_j t}]G_j`
    with anti-Hermitian :math:`G_0`: solves in the rotating frame of
    :math:`G_0` with step :math:`\Delta t`, approximating each
    frequency-shifted envelope by a Chebyshev interpolant per step and
    evaluating the precomputed multivariable Dyson series polynomial
    (Dysolve; arXiv:2210.11595). ``include_imag`` controls per-signal whether
    the sine (imaginary-envelope) variables are included. ``device=None`` is
    the CUDA device (raises without one).
    """

    _expansion_method = "dyson"

    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        model = self.model
        if jax_control_flow:
            def step_propagators(coeffs):
                return torch.movedim(model.evaluate(coeffs), -1, 0)  # (T, n, n)

            yf = _perturbative_solve_batched(step_propagators, model, signals, y0, t0, n_steps)
        else:
            def single_step(coeffs, y):
                return model.evaluate(coeffs) @ y

            yf = _perturbative_solve(single_step, model, signals, y0, t0, n_steps)
        return OdeResult(t=[t0, t0 + n_steps * model.dt], y=[y0, yf])


class MagnusSolver(_PerturbativeSolver):
    """Fixed-step LMDE solver via a precompiled truncated Magnus expansion.

    Same structure as :class:`DysonSolver` but per step evaluates
    ``Udt @ expm(polynomial(c))``: ``scipy.linalg.expm`` in the host loop, one
    batched :func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_pade` (the
    algorithm of ``jax.scipy.linalg.expm``) over all steps on the batched
    route (``solve_sweep`` uses the Taylor ``expm`` kernel instead)."""

    _expansion_method = "magnus"

    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        model = self.model
        Udt = model.Udt
        if jax_control_flow:
            def step_propagators(coeffs):
                omega = torch.movedim(model.evaluate(coeffs), -1, 0)  # (T, n, n)
                Udt_t = torch.as_tensor(Udt, device=omega.device).to(omega.dtype)
                return Udt_t @ expm_pade(omega)

            yf = _perturbative_solve_batched(step_propagators, model, signals, y0, t0, n_steps)
        else:
            def single_step(coeffs, y):
                return Udt @ scipy_expm(model.evaluate(coeffs)) @ y

            yf = _perturbative_solve(single_step, model, signals, y0, t0, n_steps)
        return OdeResult(t=[t0, t0 + n_steps * model.dt], y=[y0, yf])
