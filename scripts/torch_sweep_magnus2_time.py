#!/usr/bin/env python3
"""Kernel B2 (``csrc/sweep_magnus2.cu``, the fixed-step Magnus-2 sweep) alone on one GPU.

Three shapes: the CR gradient row's (``chip_smoke.py`` phase 6: n = 16, k = 2,
200 steps, 10,000 members, ``matrix_herm``, order 8), Lindblad config 3's
(phase 7: n = 4, k = 1, 1,000 steps, 10,240 members, ``matrix``) and n = 25
in ``matvec`` mode (k = 2, 200 steps, 10,000 members; phase 5's largest
dimension). Inputs are seeded: anti-Hermitian generators of norm ~0.3-0.6 per step (the
Lindblad shape runs them in ``matrix`` mode, as its real generator does), coefficients in [-1, 1],
frame frequencies up to 2 pi 5, norm-1 states. The kernel's time does not
depend on the values (fixed steps, no data-dependent control). Every time
is the mean of back-to-back launches between CUDA events; bounds are
``chip_smoke``'s (FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s).

Without arguments: for each shape the launch (padded columns, lanes per
member, members per warp, warps per block, blocks, shared bytes, blocks and
warps resident per SM, registers and local bytes per thread) and the
compiler's ptxas line for the instantiation launched; the kernel's time
(and at Horner order 1: loads, builds, products, one term) beside its bound,
the frame-phase table's time (formed once per call by the wrapper), the
plain version's and the complex128 eager engine's; the kernel against the
plain version; thread 0's cycles per step by part (coefficients,
generators, products and M, Horner, the rest; a build with
``-DB2_PROFILE``); and the kernel's time at every block size (1-8 warps).

With ``--ab DIR`` it times only the kernels, on the same card in turns: the
package of DIR (another checkout, e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory), this checkout, this checkout, DIR;
each turn is its own process, builds its own library and makes the same
inputs. Run from the root of a checkout:

    python3 scripts/torch_sweep_magnus2_time.py
    python3 scripts/torch_sweep_magnus2_time.py --ab build/parent

Needs one NVIDIA GPU and nvcc (about a minute; with ``--ab`` about two).
"""
import argparse
import dataclasses
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

from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # this checkout's bounds and helpers, whichever package is timed

# (name, n, k, steps, members, dt, mode, hermitian)
SHAPES = (
    ("CR gradient shape", 16, 2, 200, 10_000, 0.5, "matrix_herm", True),
    ("Lindblad config 3", 4, 1, 1_000, 10_240, 0.02, "matrix", False),
    ("n = 25 matvec", 25, 2, 200, 10_000, 0.5, "matvec", True),
)


def make_inputs(n, k, steps, members, dt, mode, hermitian, seed=0):
    gen = np.random.default_rng(seed + n)
    a = gen.normal(size=(k + 1, n, n)) + 1j * gen.normal(size=(k + 1, n, n))
    a = -1j * (a + np.conj(np.transpose(a, (0, 2, 1)))) * (0.15 / (dt * np.sqrt(n) * (k + 1)))
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    cuda = torch.device("cuda")
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, 2, k, members)), device=cuda).float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    return ssw.prepare_inputs(a[0], a[1:], w[None, :] - w[:, None], coef, y0, dt=dt, t0=0.0,
                              tile_b=1, hermitian=hermitian, mode=mode)


def turn(label):
    """One turn of --ab: the kernel alone at each shape."""
    for name, *shape in SHAPES:
        inputs = make_inputs(*shape)
        ms = smoke.cuda_ms(torch, lambda: ssw._launch_kernel(inputs), reps=5)
        print(f"{name}: {ms:.3f} ms, {label}", flush=True)


PARTS = ("coefficients", "generators", "products and M", "Horner", "rest")


def cycles_by_part(inputs):
    """Thread 0's cycles per step by part, from one launch of a build with
    ``-DB2_PROFILE`` (clock64 between the parts of the step)."""
    default = ssw._LIB
    lib = ssw._LIB = default.variant("B2_PROFILE")
    out = torch.zeros(len(PARTS), dtype=torch.int64)
    try:
        ssw._launch_kernel(inputs)  # warm-up
        torch.cuda.synchronize()
        lib.sweep_magnus2_profile(out, 1)
        ssw._launch_kernel(inputs)
        torch.cuda.synchronize()
        lib.sweep_magnus2_profile(out, 0)
    finally:
        ssw._LIB = default
    per_step = [v / inputs.steps for v in out.tolist()]
    total = sum(per_step)
    return ", ".join(f"{name} {c:.0f} ({c / total:.0%})" for name, c in zip(PARTS, per_step))


def by_part():
    for name, n, k, steps, members, dt, mode, hermitian in SHAPES:
        inputs = make_inputs(n, k, steps, members, dt, mode, hermitian)
        shape, launch_text = smoke.b2_launch(ssw, inputs)
        out = ssw._launch_kernel(inputs)[0]
        ms = smoke.cuda_ms(torch, lambda: ssw._launch_kernel(inputs), reps=5)
        order1 = dataclasses.replace(inputs, order=1)
        ms1 = smoke.cuda_ms(torch, lambda: ssw._launch_kernel(order1), reps=5)
        table_ms = smoke.cuda_ms(torch, lambda: ssw.phase_table(
            inputs.omega, inputs.t0, inputs.dt, steps, torch.float32), reps=5)
        bound_ms, bound_by = smoke.b2_bound(inputs)
        plain_ms, plain = smoke.timed_ms(torch, lambda: ssw.sweep_expm_magnus2_plain(inputs))
        diff = float((out - plain[0]).abs().max())
        eager_ms = smoke.eager_engine_ms(torch, inputs)
        blocks = []
        for w in range(1, ssw.MAX_WARPS_PER_BLOCK + 1):
            if ssw._LIB.sweep_magnus2_smem_bytes(n, k, ssw._MODES.index(mode), w) \
                    > ssw.MAX_SHARED_BYTES:
                break
            s = ssw.launch_shape(n, k, mode, members, warps=w)
            if s.blocks_per_sm < 1:  # more threads than the instantiation's bound
                break
            t = smoke.cuda_ms(torch, lambda w=w: ssw._launch_kernel(inputs, warps=w), reps=3)
            blocks.append(f"{w}: {t:.3f} ms ({s.warps_per_sm} warps/SM)")
        print(
            f"{name} (n={n}, k={k}, {steps} steps, {members} members, {mode}): kernel "
            f"{ms:.3f} ms ({ms * 1e3 / steps:.2f} us per step), order 1 {ms1:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}; the kernel at {bound_ms / ms:.0%} of it), phase "
            f"table {table_ms:.3f} ms, plain {plain_ms:.1f} ms, eager engine {eager_ms:.2f} ms, "
            f"kernel vs plain {diff:.2e}; thread 0's cycles per step: {cycles_by_part(inputs)}; "
            f"launch: {launch_text}; by warps per block: {', '.join(blocks)}",
            flush=True,
        )


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
