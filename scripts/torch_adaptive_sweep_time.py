#!/usr/bin/env python3
"""Kernel B1 (the lockstep-adaptive dopri5 sweep, ``csrc/adaptive_sweep.cu``) alone on one GPU.

The inputs are the main row's, as ``chip_smoke.py`` phase 4 builds them:
``cr_solver()`` (n = 16, k = 2 RWA operators), 10,000 amplitudes in tiles of
512 (10,240 lanes), T = 100, atol = rtol = 1e-6, h0 = 0.1, through
``solvers.fused_sweep.sweep_arguments``. Every time is the mean of
back-to-back launches between CUDA events; the bound is ``chip_smoke``'s
(this run's accepted steps, the FP32 operations over 67 TFLOP/s).

Without arguments, by part:

- the compiler's report (registers and spills of each instantiation);
- the cycles thread 0 of each block spends per step forming the tables, in
  the stages, in the reduction and cluster exchange and in the control
  (the kernel's ``clocks`` output, at the default shape);
- every launch shape the kernel can take at the row (``candidate_shapes``,
  clusters of 16 included where the card allows them, and ``shape_for`` at
  clusters of 1, 2 and 4, which run several members per lane group): the
  clusters the card co-schedules, the time, the time per step (over the
  slowest tile's steps, rejected ones included) and whether the result equals
  the default shape's bit for bit; the shape ``launch_shape`` picks is marked;
- builds of the same source with a part of the design taken back
  (``VARIANTS``: the library's ``fmod``, ``cos`` and ``sin`` in place of
  ``sincos``, no compile-time n = 16, every block of a cluster forming all
  the tables): each one's time beside the kernel as
  built, its cycles per step, and whether it equals the built kernel bit
  for bit.

With ``--ab DIR`` it times only the kernel at the row, on the same card in
turns: the package of DIR (another checkout, e.g. the parent commit unpacked
with ``git archive`` into a gitignored directory), this checkout, this
checkout, DIR; each turn is its own process, builds its own kernel and makes
the same inputs. Run from the root of a checkout:

    python3 scripts/torch_adaptive_sweep_time.py
    python3 scripts/torch_adaptive_sweep_time.py --ab build/parent

Needs one NVIDIA GPU (about a minute; with ``--ab`` about two).
"""
import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
_ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
_ARGS.add_argument("--ab", metavar="DIR", help="alternate the kernel with the checkout DIR's")
_ARGS.add_argument("--turn", metavar="DIR", help=argparse.SUPPRESS)
ARGS = _ARGS.parse_args()
# the package under test: this checkout's, or DIR's for one turn of --ab
sys.path.insert(0, str(ROOT))
if ARGS.turn:
    sys.path.insert(0, str(Path(ARGS.turn).resolve()))

from qiskit_dynamics_tpu_torch import Signal  # noqa: E402
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver  # noqa: E402
from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw  # noqa: E402
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import sweep_arguments  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # this checkout's constants and bound, whichever package is timed

TILE_B = 512


def main_row_inputs():
    """The kernel's inputs at chip_smoke's phase 4 (the main path's)."""
    cuda = torch.device("cuda")
    solver, w1 = cr_solver(device=cuda)
    y0 = np.zeros(solver.model.dim, dtype=complex)
    y0[0] = 1.0
    amps = torch.linspace(0.25, 1.0, smoke.SWEEP, dtype=torch.float64, device=cuda)

    def signals_fn(amp):
        return [Signal(lambda t: amp * smoke.AMP_SCALE, carrier_freq=w1)]

    args, kwargs, _ = sweep_arguments(
        solver.model, signals_fn, amps, (0.0, smoke.T_MAIN), y0, atol=smoke.MAIN_TOL,
        rtol=smoke.MAIN_TOL, max_steps=4096, h0=0.1, tile_b=TILE_B,
        rwa_signal_map=solver._rwa_signal_map, envelope_resolution=None, bucket_lanes=True,
        t_eval=None,
    )
    return asw.prepare_inputs(*args, **kwargs)


def kernel_ms(x, **launch):
    return smoke.cuda_ms(torch, lambda: asw._launch_kernel(x, False, **launch), reps=3)


def turn(label):
    """One turn of --ab: the kernel at the main row."""
    x = main_row_inputs()
    ms = kernel_ms(x)
    print(f"B1 at the main row ({x.batch} lanes x n = {x.n}, tile_b {x.tile_b}): {ms:.3f} ms, "
          f"{label}", flush=True)


def shape_text(shape):
    return (f"G={shape.cluster} P={shape.lanes} R={shape.rows} threads={shape.threads} "
            f"V={shape.members_per_group} S={shape.stages_per_pass} smem={shape.smem_bytes}")


def by_part():
    lib = asw._LIB
    report = Path(lib.path + ".ptxas.txt")
    lines = report.read_text().splitlines() if report.exists() else []
    print("ptxas: " + " | ".join(
        line.strip() for line in lines
        if "entry function" in line or "registers" in line or "spill" in line), flush=True)

    x = main_row_inputs()
    n, k, tiles = x.n, x.k, x.batch // x.tile_b
    default = asw.launch_shape(n, k, x.tile_b)
    steps = torch.zeros(tiles, dtype=torch.int32, device="cuda")
    base, _, record = asw._launch_kernel(x, True, steps_out=steps)
    twin, _, twin_record = asw.sweep_dopri5_lockstep_plain(x, record_steps=True)
    accepted = (record > 0).sum(dim=1).cpu().numpy()
    bound_ms, bound_by = smoke.bound(smoke.adaptive_dopri5.flops(n, k, x.tile_b, accepted),
                                     4 * (2 * k * x.batch + 4 * n * x.batch))
    most = int(steps.max())
    print(f"B1 at the main row ({x.batch} lanes x n = {n}, k = {k}, tile_b {x.tile_b}, {tiles} "
          f"tiles): steps per tile mean {float(steps.float().mean()):.1f} max {most} "
          f"(accepted mean {accepted.mean():.1f} max {accepted.max()}); bound {bound_ms:.3f} ms "
          f"({bound_by}); default shape vs twin: states equal "
          f"{bool(torch.equal(base, twin))}, step records equal "
          f"{bool(torch.equal(record, twin_record))}", flush=True)

    blocks = tiles * default.cluster
    clocks = torch.zeros((blocks, 4), dtype=torch.int64, device="cuda")
    asw._launch_kernel(x, False, clocks=clocks)
    per_step = clocks.double().mean(dim=0).cpu().numpy() / most
    names = ("tables", "stages", "reduce and exchange", "control")
    print("thread 0's cycles per step at the default shape (mean over blocks): " + ", ".join(
        f"{name} {c:.0f} ({c / per_step.sum():.0%})" for name, c in zip(names, per_step))
        + f"; {per_step.sum():.0f} in all", flush=True)

    shapes = list(asw.candidate_shapes(n, k, x.tile_b))
    shapes += [asw.shape_for(n, k, x.tile_b, g) for g in (1, 2, 4)]
    for shape in shapes:
        mark = " <- launch_shape" if shape == default else ""
        try:
            clusters = asw.active_clusters(n, k, x.tile_b, shape)
            ms = kernel_ms(x, shape=shape)
            out = asw._launch_kernel(x, False, shape=shape)[0]
        except RuntimeError as err:  # a shape the card refuses is reported, not timed
            print(f"  {shape_text(shape)}: refused ({err}){mark}", flush=True)
            continue
        print(f"  {shape_text(shape)}: {clusters} clusters co-resident, {ms:.3f} ms, "
              f"{1e3 * ms / most:.2f} us per step, equal to the default "
              f"{bool(torch.equal(out, base))}{mark}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if ARGS.turn:
        turn(ARGS.turn)
        return
    if ARGS.ab:
        for tree in (ARGS.ab, str(ROOT), str(ROOT), ARGS.ab):
            subprocess.run([sys.executable, __file__, "--turn", tree], check=True)
    else:
        by_part()
    print(smi)


if __name__ == "__main__":
    main()
