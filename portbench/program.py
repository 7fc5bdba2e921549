"""The system under test: the port's public ``Solver.solve_sweep``.

With ``portbench/programs/`` this is the only part of the benchmark that
imports the program (``qiskit_dynamics_tpu_torch``). It builds the port's
``Solver`` from a :class:`~portbench.model.Model`'s matrices and makes the
call that the window drives:

- ``"entry": "forward"``: ``solve_sweep`` under ``torch.no_grad()``;
- ``"entry": "value_and_grad"``: ``solve_sweep`` on amplitudes that require
  grad, the loss ``mean(|y[:, loss_index]|^2)`` over the members, and
  ``torch.autograd.grad`` of it with respect to the amplitudes.

A traffic mix that names ``"program": <name>`` is driven by
``portbench/programs/<name>.py`` instead: its ``Program(model, traffic,
device, span)`` makes the same call (most simply as a :class:`SweepCall`
with its own ``_solve``), and an optional ``sweep_shape(model, traffic)``
gives the sizes a work count reads.
"""
from __future__ import annotations

import contextlib

import torch

from qiskit_dynamics_tpu_torch import Signal, Solver

from .model import envelope


def build_solver(model, device) -> Solver:
    rwa = model.rwa_cutoff_ghz is not None
    return Solver(
        static_hamiltonian=model.static_hamiltonian,
        hamiltonian_operators=[d.operator for d in model.drives],
        static_dissipators=model.dissipators or None,
        rotating_frame=model.frame,
        rwa_cutoff_freq=model.rwa_cutoff_ghz if rwa else None,
        rwa_carrier_freqs=[d.carrier_ghz for d in model.drives] if rwa else None,
        vectorized=model.vectorized,
        device=device,
    )


def signals_fn(model):
    """One member's amplitude -> the solver's signals: the envelope
    ``amp * envelope_scale``, times the drive's ``envelope(t)`` where it has
    one."""
    drives = [(d.envelope_scale, d.carrier_ghz,
               None if d.envelope is None else envelope(d.envelope)) for d in model.drives]

    def signals(amp):
        sigs = [Signal(lambda t, s=scale: amp * s, carrier_freq=carrier) if env is None else
                Signal(lambda t, s=scale, e=env: amp * s * e(t), carrier_freq=carrier)
                for scale, carrier, env in drives]
        return (sigs, None) if model.vectorized else sigs

    return signals


class SweepCall:
    """The cell's call around a sweep ``_solve(amps) -> y``: ``call(amps) ->
    (y, grad or None)``, ``y`` the (B, d) final frame states or (B, d, d)
    density matrices."""

    def __init__(self, traffic: dict, span=None):
        self.entry = traffic["entry"]
        self.loss_index = traffic.get("loss_index")
        self.span = span or (lambda name: contextlib.nullcontext())
        self.sync_spans = False  # a traced run times the backward on its own
        if self.entry not in ("forward", "value_and_grad"):
            raise ValueError(f"unknown entry {self.entry!r}")

    def _solve(self, amps):
        raise NotImplementedError

    def call(self, amps):
        if self.entry == "forward":
            with torch.no_grad(), self.span("forward"):
                return self._solve(amps), None
        a = amps.clone().requires_grad_(True)
        with self.span("forward"):
            y = self._solve(a)
            loss = torch.mean(y[:, self.loss_index].abs() ** 2)
        if self.sync_spans:
            torch.cuda.synchronize()
        with self.span("backward"):
            (grad,) = torch.autograd.grad(loss, a)
            if self.sync_spans:
                torch.cuda.synchronize()
        return y.detach(), grad


class Program(SweepCall):
    """``Solver.solve_sweep`` with the traffic's ``method`` and ``options``."""

    def __init__(self, model, traffic: dict, device, span=None):
        super().__init__(traffic, span)
        self.solver = build_solver(model, device)
        self.signals = signals_fn(model)
        self.y0 = model.y0
        self.t_span = (0.0, model.t_final)
        self.method = traffic["method"]
        self.options = dict(traffic.get("options", {}))

    def _solve(self, amps):
        return self.solver.solve_sweep(self.signals, amps, t_span=self.t_span, y0=self.y0,
                                       method=self.method, **self.options)
