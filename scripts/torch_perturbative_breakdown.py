#!/usr/bin/env python3
"""Where a perturbative sweep call spends its time, on the card.

Runs the two full-width rows of ``chip_smoke.py`` (BASELINE config 4: dim-10
transmon, 1,000 steps of 0.1, 2,048 Gaussian amplitudes, ``DysonSolver`` order 6
and ``MagnusSolver`` order 3; the sweep is ``chip_smoke.perturbative_sweep``) under ``torch.profiler`` for a few forward calls
and one gradient call (8 checkpointed chunks), and prints per row: the host
time per call, the device's busy time per call (the sum of kernel times) and
its idle share, and the kernels by name with their share. Needs one NVIDIA GPU
and nvcc.

    python scripts/torch_perturbative_breakdown.py [output_file]

The full tables go to ``output_file`` (default
``build/perturbative_breakdown.txt``).
"""
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from qiskit_dynamics_tpu_torch import Signal  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import (  # noqa: E402
    dyson_transmon_solver,
    magnus_transmon_solver,
)

TOP = 14


def profiled(fn, calls):
    """(host ms per call, device busy ms per call, [(kernel, ms per call, launches per call)])."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3 / calls
    rows = []
    for event in prof.key_averages():
        device_us = getattr(event, "self_device_time_total", None)
        if device_us is None:
            device_us = event.self_cuda_time_total
        if device_us > 0 and str(event.device_type).endswith("CUDA"):
            rows.append((event.key, device_us / 1e3 / calls, event.count / calls))
    rows.sort(key=lambda row: -row[1])
    return host_ms, sum(row[1] for row in rows), rows


def report(out, title, host_ms, busy_ms, rows):
    lines = [f"{title}: host {host_ms:.2f} ms per call, device busy {busy_ms:.2f} ms per call "
             f"(idle share {max(0.0, 1.0 - busy_ms / host_ms):.2f}), "
             f"{sum(r[2] for r in rows):.0f} kernel launches per call"]
    for name, ms, count in rows:
        lines.append(f"    {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{count:8.1f}  {name[:110]}")
    out.write("\n".join(lines) + "\n\n")
    print("\n".join(lines[: TOP + 1]), flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card} (torch {torch.__version__})", flush=True)
    amps = torch.linspace(0.2, 1.0, smoke.PT_SWEEP, dtype=torch.float64, device="cuda")
    default = ROOT / "build" / "perturbative_breakdown.txt"
    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else default
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as out:
        out.write(card + "\n\n")
        for name, make in (("dyson", dyson_transmon_solver), ("magnus", magnus_transmon_solver)):
            solver, nu = make(device="cuda")
            _, _, sweep, value_and_grad = smoke.perturbative_sweep(torch, Signal, solver, nu, amps)
            report(out, f"{name} forward ({smoke.PT_SWEEP} members, {smoke.PT_STEPS} steps)", *profiled(sweep, 5))
            report(out, f"{name} value and gradient ({smoke.PT_CHUNKS} checkpointed chunks)",
                   *profiled(value_and_grad, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
