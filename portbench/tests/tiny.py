"""Tiny CPU versions of the cells: the port's plain versions at a few
members and a short time, which the tests drive through the harness."""
import json
import shutil
import time

import torch

from portbench import harness, spec

# The gradient cell and the metrics only it reports, not in BENCHMARK.json
# yet (its host-bound rate spread too widely between runs on the card's
# host for a bound of 0.25; PERF.md): a later change adds them by these entries.
GRAD_ENTRIES = {
    "workloads": [
        {"name": "cr_grad_sweep", "config": "cr_transmon_dim16", "traffic": "cr_grad_sweep",
         "chips": 1,
         "why": "closed loop of value and gradient over 10,000 amplitudes, 200 Magnus-2 steps: "
                "B2 forward, the eager adjoint bound by host launches"}],
    "end_to_end": [
        {"name": "grad_sims_per_s", "unit": "sims/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["cr_grad_sweep"]}],
    "per_layer": [
        {"name": "backward_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "adjoint: ops/sweep_ad.py", "moves": "grad_sims_per_s",
         "workloads": ["cr_grad_sweep"]},
        {"name": "launches_per_call.grad", "unit": "launches", "better": "lower",
         "source": "device_trace", "layer": "adjoint: ops/sweep_ad.py",
         "moves": "grad_sims_per_s", "workloads": ["cr_grad_sweep"]},
        {"name": "device_idle_pct.grad", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "grad_sims_per_s", "workloads": ["cr_grad_sweep"]}],
}


# BASELINE config 4, the Dyson/Magnus transmon sweep: a configuration and two
# cells that the harness takes as files and entries alone (a Gaussian
# envelope, the perturbative program), not in BENCHMARK.json yet. Their
# readings on the card are in PERF.md; their limits were set from them.
DYSOLVE_CONFIG = {
    "name": "transmon_dim10_dysolve",
    "about": "A 10-level transmon, nu = 5 GHz, alpha = -0.33 GHz, drive 2 pi r (a + a^dag) with "
             "r = 0.02 at the transmon frequency under a Gaussian envelope amp exp(-(t - T/2)^2 / "
             "(2 sigma^2)), sigma = T/6, T = 100 ns; the frame of its own H0, no RWA. BASELINE.json "
             "config 4 (qiskit-dynamics v0.6.0, docs/userguide/perturbative_solvers.rst), as "
             "qiskit_dynamics_tpu_torch.benchmarks.dyson_transmon_solver builds it; chip_smoke.py "
             "phases 12-13.",
    "model": "transmon_chain",
    "levels": 10,
    "freqs_ghz": [5.0],
    "anharmonicities_ghz": [-0.33],
    "coupling_ghz": 0.0,
    "drives": [
        {"transmon": 0, "carrier_ghz": 5.0, "operator_scale": 0.02, "envelope_scale": 1.0,
         "envelope": {"kind": "gaussian", "center": 50.0, "sigma": 100.0 / 6}}
    ],
    "damping_rates": None,
    "vectorized": False,
    "frame": "diag_static",
    "rwa_cutoff_ghz": None,
    "initial_basis_index": 0,
    "t_final": 100.0,
    "precision": "complex64: float32 arithmetic, TF32 off",
    "solve_dim": 10,
    "assumed": {"t_final": 100.0, "sigma": 100.0 / 6, "dt": 0.1, "amplitude_range": [0.2, 1.0]},
}


def _dysolve_traffic(method, order, terms, path):
    return {
        "about": f"A perturbative amplitude scan of BASELINE config 4: 2,048 Gaussian amplitudes "
                 f"a call, uniform in [0.2, 1.0), 1,000 steps of dt 0.1, {method.title()} order "
                 f"{order} with Chebyshev order 1 ({terms} monomials), through the port's "
                 f"{method.title()}Solver.solve_sweep under torch.no_grad(): {path}. The "
                 f"reference is the exact solution: the 6th-order Magnus rule on a grid of "
                 f"0.005 (halving it moves the probes by 1.2e-11).",
        "program": "perturbative_sweep",
        "members": 2048,
        "amplitude_low": 0.2,
        "amplitude_high": 1.0,
        "pool": 4,
        "entry": "forward",
        "options": {"expansion_method": method, "expansion_order": order, "chebyshev_order": 1,
                    "dt": 0.1},
        "warmup_calls": 3,
        "trace_calls": 200,
        "reference": {"magnus_order": 3, "max_dt": 0.005},
        "probes": 128,
        "work": None,
        "limits": {"state_err": 3e-3, "norm_err": 5e-3},
    }


DYSON_ENTRIES = {
    "configs": [
        {"name": "transmon_dim10_dysolve",
         "source": "https://github.com/qiskit-community/qiskit-dynamics (v0.6.0): "
                   "docs/userguide/perturbative_solvers.rst, the Dyson and Magnus solvers on a "
                   "driven transmon (BASELINE.json config 4)",
         "file": "portbench/configs/transmon_dim10_dysolve.json", "reduced": [],
         "why": "the perturbative solvers: a dim-10 transmon under a Gaussian drive, no RWA, "
                "stepped by precomputed Dyson and Magnus expansions"}],
    "workloads": [
        {"name": "dyson_sweep", "config": "transmon_dim10_dysolve", "traffic": "dyson_sweep",
         "chips": 1,
         "why": "closed loop of 2,048-amplitude scans, 1,000 Dyson-6 steps (209 monomials): the "
                "Chebyshev coefficients, the monomial table, one product and chain kernel B5"},
        {"name": "magnus_sweep", "config": "transmon_dim10_dysolve", "traffic": "magnus_sweep",
         "chips": 1,
         "why": "closed loop of 2,048-amplitude scans, 1,000 Magnus-3 steps (34 monomials): "
                "kernel B6 over 2,048,000 lanes, then the chain B5"}],
    # the cells join the lists of the metrics they report
    "cells_of": {name: ["dyson_sweep", "magnus_sweep"]
                 for name in ("sims_per_s", "launches_per_call.fwd", "device_idle_pct.fwd")},
    "files": {
        "portbench/configs/transmon_dim10_dysolve.json": DYSOLVE_CONFIG,
        "portbench/workloads/dyson_sweep.json": _dysolve_traffic(
            "dyson", 6, 209, "the vmapped Chebyshev coefficients, the monomial table, one "
            "real product against the expansion and the chain kernel B5"),
        "portbench/workloads/magnus_sweep.json": _dysolve_traffic(
            "magnus", 3, 34, "the vmapped Chebyshev coefficients, the monomial table, one "
            "real product, kernel B6 over the 2,048,000 step lanes and the chain kernel B5"),
    },
}


def copy_with(tmp_path, entries):
    """A copy of the benchmark in ``tmp_path`` with ``entries`` appended to
    its ``BENCHMARK.json`` (``"cells_of"``: cells appended to the named
    metrics' ``workloads``) and ``entries["files"]`` written as JSON files;
    returns the copy's root."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    for key, more in entries.items():
        if key == "cells_of":
            for metric in bench["end_to_end"] + bench["per_layer"]:
                if metric["name"] in more:
                    metric["workloads"] = metric["workloads"] + more[metric["name"]]
        elif key == "files":
            for path, content in more.items():
                (tmp_path / path).write_text(json.dumps(content, indent=1) + "\n")
        else:
            bench[key] = bench[key] + more
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path

# per cell: members per call and the simulated time (the full step count
# would take minutes on the CPU's plain versions)
TINY = {
    "cr_amp_sweep": (6, 10.0),
    "cr_fixed_sweep": (6, 10.0),
    "cr_grad_sweep": (6, 10.0),
    "cr_pair_open_sweep": (2, 0.8),
    "dyson_sweep": (3, 2.0),  # 20 steps of 0.1
    "magnus_sweep": (3, 2.0),
}


def tiny_cell(name, root=spec.ROOT, members=None, t_final=None):
    cell = spec.load_cell(name, root)
    m, t = TINY.get(name, (4, 1.0))
    m = members or m
    cell.traffic.update(members=m, probes=min(int(cell.traffic["probes"]), 2 * m),
                        warmup_calls=1, trace_calls=2, pool=2)
    t = t_final or t
    # an envelope's parameters are times: they shrink with the span, so that
    # the drive keeps its shape there
    for drive in cell.config["drives"]:
        for key, value in (drive.get("envelope") or {}).items():
            if key != "kind":
                drive["envelope"][key] = value * t / cell.config["t_final"]
    cell.config["t_final"] = t
    return cell


def run_tiny(cell, seed=2**31 + 77, traced=False, wrap=None, seconds=0.2):
    return harness.execute(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                           wrap=wrap)
