#!/usr/bin/env python3
"""Truncation error of the device solver methods of ``chip_smoke.py`` phase 19,
on the CPU.

The phase solves ``cr_solver()`` (n = 16, frame diag(H0), RWA) once over
T = 100 with each method of ``chip_smoke.SV_METHODS`` and holds its final
populations against the port's host DOP853 at atol = rtol = 1e-10. This runs
the same solves on the host in complex128 (the same code as on the card,
with CPU tensors), prints each method's population error against DOP853 at
1e-10 and at 1e-12, its step count and its host time, and so shows how much
of each bar is truncation.

    python scripts/torch_solver_truncation.py

Nothing here is a device measurement.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from qiskit_dynamics_tpu_torch import Signal  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver  # noqa: E402


def main():
    torch.set_num_threads(4)
    solver, w1 = cr_solver(device="cpu")
    signals, y0 = smoke.solver_surface_problem(Signal, w1, solver.model.dim)
    kw = dict(t_span=[0.0, smoke.SV_T], y0=y0, signals=signals)
    refs = {}
    for tol in (1e-10, 1e-12):
        start = time.perf_counter()
        res = solver.solve(method="DOP853", atol=tol, rtol=tol, **kw)
        refs[tol] = np.abs(res.y[-1]) ** 2
        print(f"DOP853({tol:g}): {time.perf_counter() - start:.1f} s", flush=True)
    print(f"DOP853(1e-10) vs DOP853(1e-12): {np.max(np.abs(refs[1e-10] - refs[1e-12])):.3e}")
    for method, kwargs, bar in smoke.SV_METHODS:
        start = time.perf_counter()
        res = solver.solve(method=method, **kwargs, **kw)
        seconds = time.perf_counter() - start
        pop = (res.y[-1].abs() ** 2).numpy()
        steps = f"nfev {int(res.nfev)}" if "nfev" in res else f"{round(smoke.SV_T / kwargs['max_dt'])} steps"
        print(f"{method} {kwargs}: err vs DOP853(1e-10) {np.max(np.abs(pop - refs[1e-10])):.3e}, "
              f"vs DOP853(1e-12) {np.max(np.abs(pop - refs[1e-12])):.3e} (bar {bar}); {steps}; "
              f"{seconds:.1f} s on the host", flush=True)


if __name__ == "__main__":
    main()
