"""High-level ``Solver`` class (Hamiltonian and vectorized Lindblad models).

Counterpart of ``qiskit_dynamics_tpu/solvers/solver_classes.py`` without
pulse channels: it builds a ``HamiltonianModel``, or a vectorized
``LindbladModel`` when dissipators are given, on an explicit
``device``/``dtype`` (``device=None`` is the CUDA device), optionally applies
the RWA with a cached signal map (Hamiltonian models), and exposes

- ``solve`` for one simulation with any method of ``solve_lmde``: the scipy
  methods on the host, the fixed-step, Lanczos, parallel and adaptive
  methods on the model's device;
- ``solve_sweep`` for a parameter sweep: ``method="fused_dopri5"`` through
  the lockstep-adaptive kernel, ``method="fused_magnus2"`` through the
  fixed-step kernels (differentiable; ``precision="df32"`` runs native FP64),
  ``method="chebyshev"`` through the certified Chebyshev interpolation of a
  1-d or 2-d sweep.

Pulse channels and schedules, quantum_info state types, the RWA of Lindblad
models and list-broadcast ``solve`` calls are still to be ported
(``ROADMAP.md``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..models import HamiltonianModel, LindbladModel, rotating_wave_approximation
from ..signals import Signal, SignalList
from ..unified import to_tensor
from .results import OdeResult
from .solver_functions import solve_lmde

__all__ = ["Solver"]


class Solver:
    """Solver for Hamiltonian and (vectorized) Lindblad dynamics."""

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        static_dissipators=None,
        dissipator_operators=None,
        rotating_frame=None,
        in_frame_basis: bool = False,
        vectorized: bool = False,
        rwa_cutoff_freq: Optional[float] = None,
        rwa_carrier_freqs=None,
        validate: bool = True,
        device=None,
        dtype: torch.dtype = torch.complex128,
    ):
        if static_dissipators is None and dissipator_operators is None:
            model = HamiltonianModel(
                static_operator=static_hamiltonian,
                operators=hamiltonian_operators,
                rotating_frame=rotating_frame,
                in_frame_basis=in_frame_basis,
                validate=validate,
                device=device,
                dtype=dtype,
            )
        else:
            model = LindbladModel(
                static_hamiltonian=static_hamiltonian,
                hamiltonian_operators=hamiltonian_operators,
                static_dissipators=static_dissipators,
                dissipator_operators=dissipator_operators,
                rotating_frame=rotating_frame,
                in_frame_basis=in_frame_basis,
                vectorized=vectorized,
                validate=validate,
                device=device,
                dtype=dtype,
            )
        self._rwa_signal_map = None
        self._model = model

        if rwa_cutoff_freq:
            if isinstance(model, LindbladModel):
                raise NotImplementedError(
                    "the RWA of a LindbladModel is still to be ported (ROADMAP A7, left over)."
                )
            self._model.signals = _rwa_seed_signals(rwa_carrier_freqs, hamiltonian_operators)
            self._model, self._rwa_signal_map = rotating_wave_approximation(
                self._model, rwa_cutoff_freq, return_signal_map=True
            )
            self._set_new_signals(None)

    @property
    def model(self):
        """The underlying model."""
        return self._model

    def solve(self, t_span, y0, signals=None, **kwargs) -> OdeResult:
        r"""Solve one simulation with a method of
        :func:`~qiskit_dynamics_tpu_torch.solvers.solve_lmde`
        (``method="DOP853"`` by default), signals given before the RWA (for a
        Lindblad model a list of Hamiltonian signals or a ``(hamiltonian,
        dissipator)`` tuple).

        ``y0`` is an array or tensor of shape (dim,) or (dim, m) for a
        Hamiltonian model; for a vectorized Lindblad model a (dim, dim)
        density matrix (the result is then (dim, dim) per time) or a
        column-stacked (dim^2,) / (dim^2, m) state. The result's ``y`` has
        time on axis 0, in the standard basis: a host numpy array for the
        host methods (the scipy methods, ``RK4``, ``scipy_expm``,
        ``lanczos_diag``), a tensor on the model's device for the device
        methods (``jax_expm``, ``jax_RK4``, ``tpu_dopri5``, ...), as the JAX
        package returns device arrays."""
        if kwargs.get("method", "DOP853") in (
            "fused_dopri5", "fused", "fused_magnus2", "fused_expm"
        ):
            raise DynamicsError(
                "the fused methods solve parameter sweeps: use Solver.solve_sweep."
            )
        y0 = to_tensor(y0)
        density_matrix = False
        if isinstance(self.model, LindbladModel):
            dim = self.model.dim
            density_matrix = y0.shape == (dim, dim)
            if density_matrix:
                y0 = y0.T.reshape(-1)  # column-stacking vec
            if y0.shape[0] != dim**2 or y0.ndim > 2:
                raise DynamicsError(
                    "Shape mismatch for initial state y0 and LindbladModel in vectorized mode."
                )
        elif y0.shape[0] != self.model.dim or y0.ndim > 2:
            raise DynamicsError("Shape mismatch for initial state y0 and HamiltonianModel.")
        self._set_new_signals(signals)
        try:
            results = solve_lmde(generator=self.model, t_span=t_span, y0=y0, **kwargs)
        finally:
            self._set_new_signals(None)
        if density_matrix:
            y = results.y.reshape(-1, dim, dim)
            results.y = y.transpose(1, 2) if torch.is_tensor(y) else np.swapaxes(y, 1, 2)
        return results

    def solve_sweep(self, signals_fn, params, t_span, y0, method: str = "fused_dopri5",
                    **kwargs):
        r"""Solve a parameter sweep with the fused kernel, one call per batch.

        ``signals_fn`` maps one member's parameters to the model's signal
        list as given to :meth:`solve` (before the RWA: the solver's RWA
        signal map is wired automatically); ``params`` carries the sweep on
        axis 0 (a ``(hamiltonian_signals, dissipator_signals)`` tuple for a
        Lindblad model). ``method="fused_dopri5"`` (alias ``"fused"``) is the
        lockstep-adaptive kernel
        (:func:`~qiskit_dynamics_tpu_torch.solvers.fused_sweep.fused_adaptive_sweep_solve`);
        ``method="fused_magnus2"`` (alias ``"fused_expm"``) is the
        fixed-step sweep, which needs ``max_dt`` and is differentiable in
        ``params``
        (:func:`~qiskit_dynamics_tpu_torch.solvers.fused_sweep.fused_sweep_solve`;
        its keywords ``sweep_engine``, ``magnus_order`` and ``poly_horner``
        choose among the fixed-step kernel, the member-major kernel, the
        polynomial engine and the eager engine, by ``solve_dim`` when left
        at ``"auto"``; ``precision="df32"`` runs the native-FP64 kernel B8).
        ``method="chebyshev"`` interpolates a smooth sweep from a few dozen
        df32 node solves with a certified error
        (:func:`~qiskit_dynamics_tpu_torch.solvers.sweep_interpolation.interpolated_sweep_solve`);
        a ``(p1_vals, p2_vals)`` tuple or a ``(B, 2)`` array of ``params``
        dispatches to the 2-d map
        (:func:`~qiskit_dynamics_tpu_torch.solvers.sweep_interpolation.interpolated_sweep_solve_2d`).
        ``kwargs`` go to the chosen solver.

        Returns:
            (B, ...) final states (or trajectories with ``t_eval``).
        """
        from .fused_sweep import fused_adaptive_sweep_solve, fused_sweep_solve

        rwa_signal_map = kwargs.pop("rwa_signal_map", self._rwa_signal_map)
        if method in ("fused_dopri5", "fused"):
            return fused_adaptive_sweep_solve(
                self.model, signals_fn, params, t_span=t_span, y0=y0,
                rwa_signal_map=rwa_signal_map, **kwargs,
            )
        if method in ("fused_magnus2", "fused_expm"):
            return fused_sweep_solve(
                self.model, signals_fn, params, t_span=t_span, y0=y0,
                rwa_signal_map=rwa_signal_map, **kwargs,
            )
        if method == "chebyshev":
            from .sweep_interpolation import interpolated_sweep_solve, interpolated_sweep_solve_2d

            # 2-d forms: a (p1_vals, p2_vals) tuple (product grid) or a (B, 2)
            # point array; everything else is the 1-d scalar sweep
            is_2d = (
                isinstance(params, tuple) and len(params) == 2
                and all(len(_shape(q)) == 1 for q in params)
            ) or (
                not isinstance(params, tuple) and len(_shape(params)) == 2
                and _shape(params)[1] == 2
            )
            cheb = interpolated_sweep_solve_2d if is_2d else interpolated_sweep_solve
            return cheb(
                self.model, signals_fn, params, t_span=t_span, y0=y0,
                rwa_signal_map=rwa_signal_map, **kwargs,
            )
        raise DynamicsError(
            f"unknown solve_sweep method {method!r}; use 'fused_dopri5', 'fused_magnus2' or "
            "'chebyshev'."
        )

    def _set_new_signals(self, signals):
        """Set (possibly RWA-mapped) signals on the model."""
        if isinstance(self.model, LindbladModel):
            if signals is None:
                signals = (None, None)
            elif not isinstance(signals, tuple):
                signals = (signals, None)
        elif signals is not None and self._rwa_signal_map:
            signals = self._rwa_signal_map(signals)
        self.model.signals = signals


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _rwa_seed_signals(carrier_freqs, ham_ops) -> List[Signal]:
    """Placeholder ``Signal(1.0, f)`` list seeding the RWA term masking:
    explicit ``rwa_carrier_freqs``, or all zeros by operator count."""
    if carrier_freqs is None:
        carrier_freqs = [0.0] * len(ham_ops) if ham_ops is not None else []
    return SignalList([Signal(1.0, carrier_freq=f) for f in carrier_freqs])
