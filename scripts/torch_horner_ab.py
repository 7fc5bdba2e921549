#!/usr/bin/env python3
"""Kernel B4 (the Horner expm action, ``csrc/horner_apply.cu``) alone on one GPU.

Inputs are random transposed planes of norm ~0.5 and states, made on the card
from a seed. Every time is the mean of back-to-back launches between CUDA
events; the bound is the bytes the function must move (each matrix and state
read once, the result written once) at 3.35 TB/s.

Without arguments, by part, at the dim-256 row's shape (2,048 members,
n = 256):

- the resident kernel (the route ``horner_apply_bm`` takes) and the streaming
  kernel at Horner orders 1, 2, 4, 8 and 12, with the least-squares line
  through them: the intercept is what a launch costs with no iteration (the
  matrix load and the block turnover), the slope what each iteration adds;
- the clusters of C = 1, 2, 4 and 8 blocks that the card co-schedules at the
  resident kernel's block shape (0: C blocks cannot hold the matrix);
- the compiler's report for the source (registers, spills, shared memory);

then at order 8 at five shapes (2,048 x 256, 10,240 x 64, 2,048 x 100, which
the resident kernel takes, and 512 x 320 and 2,048 x 512, past its n <= 256,
which the streaming kernel takes): the kernel, the streaming kernel forced at
the same shape, ``horner_twin_bm`` and the bound.

With ``--ab DIR`` it times only the kernel, at the dim-256 shape by order
and at those five shapes at order 8, on the same card in turns: the package
of DIR (another checkout, e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory), this checkout, this checkout, DIR;
each turn is its own process, so each builds its own kernel. Run from the
root of a checkout:

    python3 scripts/torch_horner_ab.py
    python3 scripts/torch_horner_ab.py --ab build/parent

Needs one NVIDIA GPU (about a minute; with ``--ab`` about two). The
cluster count comes from ``horner_apply_active_clusters`` of the kernel
library (the CUDA occupancy calculator at the kernel's launch shape).
"""
import argparse
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

from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp  # noqa: E402

ROW = (2048, 256)  # the dim-256 Lindblad row of chip_smoke.py phase 10
SHAPES = (ROW, (10240, 64), (2048, 100), (512, 320), (2048, 512))
ORDERS = (1, 2, 4, 8, 12)
ORDER = 8
PEAK_BYTES = 3.35e12


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def planes_for(members, n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 0.5 / n**0.5
    planes = [torch.randn(members, n, n, device="cuda", generator=gen) * scale for _ in range(2)]
    return planes + [torch.randn(members, n, device="cuda", generator=gen) for _ in range(2)]


def bound_ms(members, n):
    return 4 * (2 * members * n * n + 4 * members * n) / PEAK_BYTES * 1e3


def turn(label):
    """One turn of --ab: the kernel at the row's shape by order and at SHAPES."""
    members, n = ROW
    planes = planes_for(members, n)
    times = [event_ms(lambda o=o: hp._launch_kernel(*planes, o)) for o in ORDERS]
    intercept, slope = fit(ORDERS, times)
    print(f"B4 B={members} n={n} at orders {ORDERS}, {label}: "
          + ", ".join(f"{t:.3f}" for t in times)
          + f" ms; line {intercept:.3f} ms + {slope:.3f} ms per iteration", flush=True)
    del planes
    for members, n in SHAPES:
        planes = planes_for(members, n)
        ms = event_ms(lambda: hp._launch_kernel(*planes, ORDER))
        route = "resident" if hp._LIB.horner_apply_cluster(n) else "streaming"
        print(f"B4 B={members} n={n} order {ORDER} ({route}), {label}: {ms:.3f} ms", flush=True)
        del planes


def fit(orders, times):
    slope, intercept = np.polyfit(np.asarray(orders, float), np.asarray(times, float), 1)
    return intercept, slope


def by_part():
    lib = hp._LIB
    report = Path(lib.path + ".ptxas.txt")
    print("ptxas: " + " | ".join(
        line.strip() for line in (report.read_text().splitlines() if report.exists() else [])
        if "entry function" in line or "registers" in line or "spill" in line), flush=True)
    members, n = ROW
    planes = planes_for(members, n)
    resident = [event_ms(lambda o=o: hp._launch_kernel(*planes, o)) for o in ORDERS]
    streaming = [event_ms(lambda o=o: hp._launch_kernel(*planes, o, force_stream=True), reps=3)
                 for o in ORDERS]
    for name, times in (("resident", resident), ("streaming", streaming)):
        intercept, slope = fit(ORDERS, times)
        print(f"B4 B={members} n={n} {name} at orders {ORDERS}: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f" ms; line {intercept:.3f} ms + {slope:.3f} ms per iteration", flush=True)
    clusters = {c: lib.horner_apply_active_clusters(n, c) for c in (1, 2, 4, 8)}
    print(f"B4 n={n}: the resident kernel takes C = {lib.horner_apply_cluster(n)}; clusters "
          "co-scheduled by C: " + ", ".join(f"C={c}: {k}" for c, k in clusters.items()),
          flush=True)
    del planes
    for members, n in SHAPES:
        planes = planes_for(members, n)
        kernel = event_ms(lambda: hp._launch_kernel(*planes, ORDER))
        stream = event_ms(lambda: hp._launch_kernel(*planes, ORDER, force_stream=True), reps=3)
        plain = event_ms(lambda: hp.horner_twin_bm(*planes, order=ORDER), reps=3)
        ur, ui = hp._launch_kernel(*planes, ORDER)
        plain_r, plain_i = hp.horner_twin_bm(*planes, order=ORDER)
        diff = float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max()))
        cluster = lib.horner_apply_cluster(n)
        clusters = lib.horner_apply_active_clusters(n, cluster) if cluster else 0
        print(f"B4 B={members} n={n} order {ORDER}: C={cluster} ({clusters} clusters "
              f"co-scheduled): kernel {kernel:.3f} ms, streaming {stream:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bound_ms(members, n):.3f} ms (bytes), kernel vs plain "
              f"{diff:.2e}", flush=True)
        del planes, ur, ui, plain_r, plain_i


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
