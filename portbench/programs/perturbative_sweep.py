"""``"program": "perturbative_sweep"``: the port's perturbative solvers,
``DysonSolver`` or ``MagnusSolver``, and their ``solve_sweep``.

The solver is built from the :class:`~portbench.model.Model` as BASELINE
config 4 builds it (``qiskit_dynamics_tpu_torch.benchmarks``'s
``dyson_transmon_solver``): operators ``-i D_j``, rotating frame ``-i H0``,
the drives' carriers, and the expansion computed to atol = rtol = 1e-12. The
traffic's ``options`` give ``expansion_method`` (``"dyson"`` or
``"magnus"``), ``expansion_order``, ``chebyshev_order`` and the step ``dt``;
a call is ``solve_sweep(0, t_final / dt, y0, signals, amps)``.

The perturbative solvers put the whole static Hamiltonian in the frame, so
the model's static Hamiltonian must be its diagonal frame, which the
reference's frame is; they take neither the rotating-wave approximation nor
dissipators.
"""
from __future__ import annotations

import numpy as np

from qiskit_dynamics_tpu_torch.solvers import DysonSolver, MagnusSolver

from ..program import SweepCall, signals_fn

SOLVERS = {"dyson": DysonSolver, "magnus": MagnusSolver}
EXPANSION_TOL = 1e-12


def steps(model, traffic) -> int:
    """The solver's steps of ``dt`` over the model's span; they must fill it."""
    dt = float(traffic["options"]["dt"])
    count = round(model.t_final / dt)
    if count < 1 or abs(count * dt - model.t_final) > 1e-9 * model.t_final:
        raise ValueError(f"t_final {model.t_final} is not a whole number of steps of {dt}")
    return count


def sweep_shape(model, traffic) -> dict:
    """The sizes a work count reads: the state's n, the drives k, the steps,
    the members and the expansion's method and orders (its monomials are the
    multisets of at most ``expansion_order`` of the ``2 k (chebyshev_order +
    1)`` Chebyshev variables: 209 for Dyson 6, 34 for Magnus 3 at k = 1)."""
    opts = traffic["options"]
    return dict(n=model.dim, k=len(model.drives), steps=steps(model, traffic),
                members=int(traffic["members"]), expansion_method=opts["expansion_method"],
                expansion_order=int(opts["expansion_order"]),
                chebyshev_order=int(opts["chebyshev_order"]))


def build_solver(model, traffic, device):
    if model.vectorized or model.dissipators:
        raise ValueError("the perturbative solvers take no dissipators")
    if model.rwa_cutoff_ghz is not None:
        raise ValueError("the perturbative solvers take no rotating-wave approximation")
    if not np.array_equal(model.static_hamiltonian, np.diag(model.frame)):
        raise ValueError("the perturbative solvers need a static Hamiltonian equal to its "
                         "diagonal frame")
    opts = traffic["options"]
    return SOLVERS[opts["expansion_method"]](
        operators=[-1j * d.operator for d in model.drives],
        rotating_frame=-1j * model.static_hamiltonian,
        dt=float(opts["dt"]),
        carrier_freqs=[d.carrier_ghz for d in model.drives],
        chebyshev_orders=[int(opts["chebyshev_order"])] * len(model.drives),
        expansion_order=int(opts["expansion_order"]),
        device=device,
        atol=EXPANSION_TOL,
        rtol=EXPANSION_TOL,
    )


class Program(SweepCall):
    def __init__(self, model, traffic: dict, device, span=None):
        super().__init__(traffic, span)
        self.solver = build_solver(model, traffic, device)
        self.signals = signals_fn(model)
        self.y0 = model.y0
        self.steps = steps(model, traffic)

    def _solve(self, amps):
        return self.solver.solve_sweep(0.0, self.steps, self.y0, self.signals, amps)
