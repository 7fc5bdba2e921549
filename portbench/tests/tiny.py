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


def copy_with(tmp_path, entries):
    """A copy of the benchmark in ``tmp_path`` with ``entries`` appended to
    its ``BENCHMARK.json``; returns the copy's root."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    for key, more in entries.items():
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
}


def tiny_cell(name, root=spec.ROOT, members=None, t_final=None):
    cell = spec.load_cell(name, root)
    m, t = TINY.get(name, (4, 1.0))
    m = members or m
    cell.traffic.update(members=m, probes=min(int(cell.traffic["probes"]), 2 * m),
                        warmup_calls=1, trace_calls=2, pool=2)
    cell.config["t_final"] = t_final or t
    return cell


def run_tiny(cell, seed=2**31 + 77, traced=False, wrap=None, seconds=0.2):
    return harness.execute(cell, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                           wrap=wrap)
