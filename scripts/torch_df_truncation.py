#!/usr/bin/env python3
"""Truncation error of the port's high-precision (df32) rows, on the CPU.

For the rows of ``chip_smoke.py`` phases 15-17 this runs the probe members
only, through the port's native-FP64 paths on the host (the plain versions,
so no kernel), and prints each row's error measure, max |y - ref| over the
complex states, against the port's DOP853 at atol = rtol = 1e-12 (the sweeps,
probes and references are ``chip_smoke.py``'s own definitions):

- the CR df32 rows (n = 16, 500 steps of Magnus-3 at max_dt 0.2), constant
  and Gaussian envelopes;
- the three probe points of the Chebyshev 2-d map, solved directly (the
  interpolation's own error is certified at run time);
- the FP64 Dysolve rows: ``DysonSolver`` at Chebyshev order 2 and expansion
  order 5, and ``MagnusSolver`` over a ladder of (Chebyshev order, expansion
  order), which picks ``chip_smoke.MAGNUS_DF``: the cheapest configuration
  whose truncation leaves a margin of 3 under the 1e-8 bar.

    python scripts/torch_df_truncation.py

In float64 the arithmetic adds ~1e-13, so each number is the step rule's or
the expansion's truncation, and what is left under the bar is the card's
margin. Nothing here is a device measurement.
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
    cr_solver,
    dyson_transmon_solver,
    magnus_transmon_solver,
)

MAGNUS_LADDER = ((1, 3), (2, 3), (2, 4), (2, 5))


def cr_rows():
    solver, w1 = cr_solver(device="cpu")
    y0 = np.zeros(solver.model.dim, dtype=complex)
    y0[0] = 1.0
    amps = np.linspace(0.25, 1.0, smoke.DF_SWEEP)[smoke.df_probes()]
    for name, gaussian, count in (("df32", False, smoke.PROBES), ("df32_gauss", True, 2)):
        fn = smoke.df_cr_signals(torch, Signal, w1, gaussian)
        params = [torch.tensor(a) for a in amps[:count]]
        refs, ref_s = smoke.df_references(solver, fn, params, y0)
        start = time.perf_counter()
        out = solver.solve_sweep(fn, torch.as_tensor(amps[:count]), t_span=(0.0, smoke.T_MAIN),
                                 y0=y0, method="fused_magnus2", max_dt=smoke.DF_MAX_DT,
                                 precision="df32").numpy()
        print(f"{name}: {count} probes, {int(smoke.T_MAIN / smoke.DF_MAX_DT)} steps of Magnus-3: "
              f"max |y - ref| {np.max(np.abs(out - refs)):.3e} (bar {smoke.DF_TOL}; sweep "
              f"{time.perf_counter() - start:.1f} s, DOP853 1e-12 {ref_s:.1f} s/member)",
              flush=True)

    def map_fn(pq):
        amp, det = pq
        return [Signal(lambda t: amp * smoke.AMP_SCALE, carrier_freq=w1 + det)]

    a = np.linspace(0.25, 1.0, smoke.CHEB_MAP)
    d = np.linspace(-smoke.CHEB_DETUNING, smoke.CHEB_DETUNING, smoke.CHEB_MAP)
    corners = ((0, 0), (smoke.CHEB_MAP // 2, smoke.CHEB_MAP // 2),
               (smoke.CHEB_MAP - 1, smoke.CHEB_MAP - 1))
    q1, q2 = np.array([a[i] for i, _ in corners]), np.array([d[j] for _, j in corners])
    refs, _ = smoke.df_references(
        solver, map_fn, [(torch.tensor(x), torch.tensor(y)) for x, y in zip(q1, q2)], y0)
    out = solver.solve_sweep(map_fn, (torch.as_tensor(q1), torch.as_tensor(q2)),
                             t_span=(0.0, smoke.T_MAIN), y0=y0, method="fused_magnus2",
                             max_dt=smoke.DF_MAX_DT, precision="df32").numpy()
    print(f"cheb2d probes solved directly: max |y - ref| {np.max(np.abs(out - refs)):.3e}",
          flush=True)


def dysolve_rows():
    amps = np.linspace(0.2, 1.0, smoke.PT_SWEEP)[smoke.perturbative_probes()]
    refs, ref_s = smoke.perturbative_references(solve_ode, amps)
    configs = [("dyson_df", dyson_transmon_solver, dict(chebyshev_order=2, expansion_order=5))]
    configs += [("magnus_df", magnus_transmon_solver,
                 dict(chebyshev_order=c, expansion_order=o)) for c, o in MAGNUS_LADDER]
    for name, make, config in configs:
        start = time.perf_counter()
        solver, nu = make(device="cpu", **config)
        build_s = time.perf_counter() - start
        sweep = smoke.dysolve_df_sweep(torch, Signal, solver, nu, torch.from_numpy(amps))
        start = time.perf_counter()
        out = sweep().numpy()
        terms = len(solver.model.expansion_polynomial.monomial_labels)
        print(f"{name} {config}: {terms} monomials (precompute {build_s:.1f} s), "
              f"{smoke.PT_STEPS} steps of {smoke.PT_DT}: max |y - ref| "
              f"{np.max(np.abs(out - refs)):.3e} (bar {smoke.DF_TOL}; sweep "
              f"{time.perf_counter() - start:.1f} s; {len(amps)} probes vs DOP853 1e-12 at "
              f"{ref_s:.1f} s/member)", flush=True)


def main():
    torch.set_num_threads(4)
    cr_rows()
    dysolve_rows()


if __name__ == "__main__":
    main()
