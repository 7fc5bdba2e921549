#!/usr/bin/env python3
"""Truncation error of the port's large-dimension fixed-step rows, on the CPU.

For the three full-width rows of ``chip_smoke.py`` (Lindblad dim 8 with
Magnus-3 at max_dt 0.05 and Magnus-2 at max_dt 0.02 on the member engine;
Lindblad dim 256 with Magnus-3 at max_dt 0.08 on the polynomial engine) this
runs the probe members only, in float64 on the host (the plain versions, so
no kernel), and in float32 on the host for comparison, and prints the
largest density-matrix entry error against the port's DOP853 at
atol = rtol = 1e-12. The float64 error is the step rule's own truncation:
what is left under each row's accuracy limit is the room for float32
roundoff on the card.

    python scripts/torch_large_dim_truncation.py [--skip-256]

Nothing here is a device measurement.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qiskit_dynamics_tpu_torch import Signal  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import (  # noqa: E402
    lindblad_qudit_solver,
    lindblad_two_transmon_solver,
)
from qiskit_dynamics_tpu_torch.ops.member_sweep import sweep_expm_magnus2_member  # noqa: E402
from qiskit_dynamics_tpu_torch.ops.polynomial_sweep import sweep_expm_magnus_poly  # noqa: E402
from qiskit_dynamics_tpu_torch.solvers.fixed_step_solvers import get_fixed_step_sizes  # noqa: E402
from qiskit_dynamics_tpu_torch.ops.magnus_rule import MAGNUS_NODES  # noqa: E402
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import (  # noqa: E402
    _extract_generator_data,
    fused_sweep_solve,
)


def float64_sweep(solver, rho0, carrier, amps, t_final, max_dt, magnus, engine):
    """The row's engine in float64 for ``amps``: (B, n, n) density matrices."""
    model = solver.model
    _, dim, static, ops, omega, t0, tf = _extract_generator_data(model, (0.0, t_final), "truncation")
    _, h, steps = get_fixed_step_sizes((t0, tf), None, max_dt)
    steps, dt = int(steps[0]), float(h[0])
    times = torch.as_tensor(t0 + dt * (np.arange(steps)[:, None] + MAGNUS_NODES[magnus][None, :]))
    amps = torch.as_tensor(amps, dtype=torch.float64)
    coef = torch.stack([Signal(a, carrier_freq=carrier)(times) for a in amps], dim=-1)[:, :, None]
    rho_fb = model.rotating_frame.operator_into_frame_basis(rho0)
    y0 = rho_fb.T.reshape(-1)[:, None].expand(dim, len(amps))
    if engine == "member":
        yf = sweep_expm_magnus2_member(static, ops, omega, coef, y0, dt=dt, t0=t0, magnus=magnus)
    else:
        yf = sweep_expm_magnus_poly(static, ops, 1j * omega[:, 0], coef, y0, dt=dt, t0=t0,
                                    magnus_order=magnus, horner="einsum")
    n = model.dim
    rho = yf.reshape(n, n, len(amps)).permute(2, 1, 0)
    return model.rotating_frame.operator_out_of_frame_basis(rho).numpy(), steps


def row(name, solver, rho0, carrier, amps, t_final, max_dt, magnus, engine):
    start = time.perf_counter()
    refs = [
        solver.solve(t_span=[0.0, t_final], y0=rho0, method="DOP853", atol=1e-12, rtol=1e-12,
                     signals=[Signal(float(a), carrier_freq=carrier)]).y[-1]
        for a in amps
    ]
    ref_s = (time.perf_counter() - start) / len(amps)
    out64, steps = float64_sweep(solver, rho0, carrier, amps, t_final, max_dt, magnus, engine)
    out32 = fused_sweep_solve(
        solver.model, lambda a: ([Signal(lambda t: a, carrier_freq=carrier)], None),
        torch.as_tensor(amps, dtype=torch.float64), (0.0, t_final), max_dt, rho0,
        sweep_engine=engine, magnus_order=magnus,
    ).numpy()
    err64 = max(float(np.max(np.abs(o - r))) for o, r in zip(out64, refs))
    err32 = max(float(np.max(np.abs(o - r))) for o, r in zip(out32, refs))
    print(f"{name}: {steps} steps, engine {engine}, magnus {magnus}: float64 truncation "
          f"{err64:.3e}, float32 on the host {err32:.3e} (max entry error over {len(amps)} probes "
          f"vs DOP853 1e-12 at {ref_s:.1f} s/member)", flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-256", action="store_true")
    args = parser.parse_args()
    torch.set_num_threads(4)
    solver, rho0, carrier = lindblad_qudit_solver(device="cpu")
    amps = np.linspace(0.2, 1.0, 10_240)[[0, 5_120, 10_239]]
    row("lindblad dim 8 (solve_dim 64), max_dt 0.05", solver, rho0, carrier, amps, 20.0, 0.05, 3,
        "member")
    row("lindblad dim 8 (solve_dim 64), max_dt 0.02", solver, rho0, carrier, amps, 20.0, 0.02, 2,
        "member")
    if not args.skip_256:
        solver, rho0, carrier = lindblad_two_transmon_solver(device="cpu")
        amps = np.linspace(0.2, 1.0, 2_048)[[0, 2_047]]
        row("lindblad dim 256 (two transmons), max_dt 0.08", solver, rho0, carrier, amps, 10.0,
            0.08, 3, "poly")


if __name__ == "__main__":
    main()
