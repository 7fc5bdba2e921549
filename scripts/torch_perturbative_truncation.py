#!/usr/bin/env python3
"""Truncation error of the port's perturbative sweep rows, on the CPU.

For the two full-width rows of ``chip_smoke.py`` (BASELINE config 4: a dim-10
transmon, 1,000 Dysolve steps of dt = 0.1, Gaussian envelope, with
``DysonSolver`` at expansion order 6 and ``MagnusSolver`` at order 3 with one
squaring, Chebyshev order 1) this runs the three probe members only through
``solve_sweep`` on the host (the plain versions, so no kernel), in complex128
and in complex64, and prints the row's error measure, max | |y| - |ref| |,
against the port's DOP853 at atol = rtol = 1e-12 rotated into the frame (the
sweep and the references are ``chip_smoke.py``'s own definitions). The
complex128 error is the expansion's own truncation: what is left under the
1e-5 bar is the room for float32 roundoff on the card.

    python scripts/torch_perturbative_truncation.py

Nothing here is a device measurement.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from qiskit_dynamics_tpu_torch import Signal, solve_ode  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import (  # noqa: E402
    dyson_transmon_solver,
    magnus_transmon_solver,
)


def main():
    torch.set_num_threads(4)
    amps = np.linspace(0.2, 1.0, smoke.PT_SWEEP)[smoke.perturbative_probes()]
    refs, ref_s = smoke.perturbative_references(solve_ode, amps)
    for name, make in (("dyson order 6", dyson_transmon_solver),
                       ("magnus order 3, 1 squaring", magnus_transmon_solver)):
        errors = {}
        for dtype in (torch.complex128, torch.complex64):
            start = time.perf_counter()
            solver, nu = make(device="cpu", dtype=dtype)
            build_s = time.perf_counter() - start
            _, _, sweep, _ = smoke.perturbative_sweep(
                torch, Signal, solver, nu, torch.from_numpy(amps))
            out = sweep().numpy()
            errors[dtype] = (float(np.max(np.abs(np.abs(out) - np.abs(refs)))),
                             float(np.max(np.abs(out - refs))))
        terms = len(solver.model.expansion_polynomial.monomial_labels)
        print(f"{name}: {terms} monomials (precompute {build_s:.2f} s), {smoke.PT_STEPS} steps of "
              f"{smoke.PT_DT}: max ||y| - |ref|| complex128 (truncation) {errors[torch.complex128][0]:.3e}, "
              f"complex64 on the host {errors[torch.complex64][0]:.3e}; max |y - ref| "
              f"complex128 {errors[torch.complex128][1]:.3e}, complex64 "
              f"{errors[torch.complex64][1]:.3e} ({len(amps)} probes vs DOP853 1e-12 at "
              f"{ref_s:.1f} s/member)", flush=True)


if __name__ == "__main__":
    main()
