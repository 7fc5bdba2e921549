#!/usr/bin/env python3
"""Kernel B3 (the member-major Magnus-2/3 sweep) alone on the card, by part.

At the dim-8 Lindblad rows of ``chip_smoke.py`` phase 9 (solve_dim n = 64,
10,240 members, T = 20: 400 Magnus-3 steps at dt = 0.05 and 1,000 Magnus-2
steps at dt = 0.02) this captures the kernel's inputs from one
``Solver.solve_sweep`` call per row, then times the kernel with CUDA events
on variations that use only its existing arguments, so that the differences
split its time:

- the row as it runs (Horner order 8, ``hermitian=False``);
- ``order=1`` (one Horner mat-vec instead of 8): the Horner action's share;
- at Magnus-2, ``hermitian=True`` on the same inputs (one product instead of
  two; the result is not the row's): half of the products' share (the
  kernel forms Magnus-3's brackets from two products either way);
- the rotated-table kernel ``member_tables_kernel`` alone, from a
  ``torch.profiler`` trace of one launch (device time by kernel name).

It prints one line per variation with the time and the bound of
``chip_smoke.b3_bound`` (both the FP32 and the 3xTF32 tensor-core bound), the
compiler's report for the source (registers, spills, shared memory), the
shared memory and blocks per SM of the launch, and the card's name and power
limit.

    python scripts/torch_member_sweep_time.py
    python scripts/torch_member_sweep_time.py --ab build/parent
    python scripts/torch_member_sweep_time.py --control

With ``--ab DIR`` it times only the two rows and three shapes of
``chip_smoke.member_problem`` at 10,240 members and 100 steps (Magnus-2 at
n = 128, where the matrices live in the device-memory scratch, and both
rules at n = 64 with two operators), on the same card in turns: the package
of DIR (another checkout, e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory), this checkout, this checkout, DIR;
each turn is its own process, so each imports and builds its own kernel.

With ``--control`` it runs ``chip_smoke.b3_bracket_diffs`` (the kernel
against its plain version in complex128 where the brackets dominate) on
the kernel as built and on a control built with
``-DMEMBER_SWEEP_ONE_PASS_TF32`` (single-pass TF32 products), and prints
both beside ``chip_smoke.B3_BRACKET_TOL``: the control must exceed it.

Needs one NVIDIA GPU (about a minute; with ``--ab`` about three).
"""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
_ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
_ARGS.add_argument("--ab", metavar="DIR", help="alternate the two rows with the checkout DIR")
_ARGS.add_argument("--control", action="store_true",
                   help="the bracket-dominated check on the kernel and a single-pass TF32 build")
_ARGS.add_argument("--rows-from", metavar="DIR", help=argparse.SUPPRESS)
ARGS = _ARGS.parse_args()
# the package under test: this checkout's, or DIR's for one turn of --ab
sys.path.insert(0, str(ROOT))
if ARGS.rows_from:
    sys.path.insert(0, str(Path(ARGS.rows_from).resolve()))

import chip_smoke as smoke  # noqa: E402
from qiskit_dynamics_tpu_torch import Signal  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import lindblad_qudit_solver  # noqa: E402
from qiskit_dynamics_tpu_torch.ops import member_sweep as msw  # noqa: E402


def captured_inputs(solver, rho0, carrier, magnus, max_dt):
    """The kernel's inputs on the row's path (sweep_engine "auto" -> member)."""
    amps = torch.linspace(0.2, 1.0, smoke.L8_SWEEP, dtype=torch.float64, device="cuda")

    def signals_fn(amp):
        return ([Signal(lambda t: amp, carrier_freq=carrier)], None)

    with smoke.Capture(msw) as cap:
        solver.solve_sweep(signals_fn, amps, t_span=(0.0, smoke.L8_T), y0=rho0,
                           method="fused_magnus2", max_dt=max_dt, magnus_order=magnus)
        torch.cuda.synchronize()
    (inputs,) = cap.last
    return inputs


def kernel_times_by_name(inputs):
    """Device milliseconds per kernel name over one launch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    msw._launch_kernel(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        msw._launch_kernel(inputs)
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0.0)
        if "member_" in event.key and device_us > 0:
            out[event.key] = device_us / 1e3
    return out


AB_SHAPES = ((2, 128), (2, 64), (3, 64))  # (magnus, n) with k = 2 operators
AB_MEMBERS, AB_STEPS = 10_240, 100


def rows_only(label):
    """One turn of --ab: the two rows' kernel times and AB_SHAPES', nothing else."""
    solver, rho0, carrier = lindblad_qudit_solver(device="cuda")
    for magnus, max_dt, _ in smoke.L8_ROWS:
        row = captured_inputs(solver, rho0, carrier, magnus, max_dt)
        ms = smoke.cuda_ms(torch, lambda: msw._launch_kernel(row), reps=2)
        print(f"B3 Magnus-{magnus} row, {label}: {ms:.1f} ms", flush=True)
    for magnus, n in AB_SHAPES:
        # anti-Hermitian generators keep the states bounded over the 100 steps
        args = smoke.member_problem(torch, n, AB_MEMBERS, AB_STEPS, magnus, True, k=2)
        x = msw.prepare_inputs(*args, dt=0.05, t0=0.2, magnus=magnus)
        ms = smoke.cuda_ms(torch, lambda x=x: msw._launch_kernel(x), reps=1)
        print(f"B3 Magnus-{magnus} n={n} k=2 B={AB_MEMBERS} T={AB_STEPS}, {label}: {ms:.1f} ms",
              flush=True)


def control():
    """The bracket-dominated check on the kernel as built and on the
    single-pass TF32 control build."""
    default = msw._LIB
    for name, defines in (("3xTF32 (as built)", ()),
                          ("single-pass TF32 control", ("MEMBER_SWEEP_ONE_PASS_TF32",))):
        msw._LIB = default.variant(*defines)
        try:
            diffs = smoke.b3_bracket_diffs(torch, msw)
        finally:
            msw._LIB = default
        worst = max(diff for _, diff in diffs)
        print(f"B3 bracket-dominated vs complex128, {name}: max {worst:.3e} "
              f"({'exceeds' if worst > smoke.B3_BRACKET_TOL else 'within'} "
              f"{smoke.B3_BRACKET_TOL}); " + ", ".join(
                  f"magnus {m} n={n} hermitian {h}: {d:.3e}" for (m, n, h), d in diffs),
              flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if ARGS.rows_from:
        rows_only(ARGS.rows_from)
        return
    if ARGS.ab:
        for tree in (ARGS.ab, str(ROOT), str(ROOT), ARGS.ab):
            subprocess.run([sys.executable, __file__, "--rows-from", tree], check=True)
        print(smi)
        return
    if ARGS.control:
        control()
        print(smi)
        return
    lib = msw._LIB
    report = Path(lib.path + ".ptxas.txt")
    print("ptxas: " + " | ".join(
        line.strip() for line in (report.read_text().splitlines() if report.exists() else [])
        if "registers" in line or "spill" in line or "smem" in line), flush=True)

    solver, rho0, carrier = lindblad_qudit_solver(device="cuda")
    for magnus, max_dt, _ in smoke.L8_ROWS:
        row = captured_inputs(solver, rho0, carrier, magnus, max_dt)
        smem = lib.member_sweep_smem_bytes(row.n, row.k, 1)
        print(f"B3 Magnus-{magnus} n={row.n} k={row.k} B={row.batch} T={row.steps} "
              f"order={row.order}: {smem} B of shared memory per block, "
              f"{smoke.b3_blocks_per_sm(lib, row)} blocks per SM", flush=True)
        variations = (("row", row), ("order 1", dataclasses.replace(row, order=1)))
        if magnus == 2:
            variations += (("hermitian", dataclasses.replace(row, hermitian=True)),)
        for name, x in variations:
            ms = smoke.cuda_ms(torch, lambda x=x: msw._launch_kernel(x), reps=1)
            bounds = smoke.b3_bounds(x)
            print(f"B3 Magnus-{magnus} {name}: {ms:.1f} ms; bound {bounds['f32_ms']:.1f} ms at "
                  f"the FP32 rate ({bounds['f32_ms'] / ms:.0%}), {bounds['tf32x3_ms']:.1f} ms "
                  f"with the products in 3xTF32 ({bounds['tf32x3_ms'] / ms:.0%}); "
                  f"products alone {bounds['products_f32_ms']:.1f} / "
                  f"{bounds['products_tf32x3_ms']:.1f} ms", flush=True)
        by_name = kernel_times_by_name(row)
        print(f"B3 Magnus-{magnus} by kernel (torch.profiler, one launch): " + ", ".join(
            f"{key} {value:.3f} ms" for key, value in sorted(by_name.items())), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
