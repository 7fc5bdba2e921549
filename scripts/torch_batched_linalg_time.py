#!/usr/bin/env python3
"""Kernels B6, B7 and B10 (``csrc/batched_linalg.cu``) alone on one GPU.

The shapes are the Magnus rows' (``chip_smoke.py`` phases 13 and 17): n = 10,
order 12, one squaring; the Taylor expm (B6) over 2,048,000 lanes (the
forward), 256,000 (a chunk of the gradient) and, in complex128, over
1,024,000 (one pass of the FP64 Magnus Dysolve), its
backward (B7) over 256,000, the batched product (B10) over 1,024,000; and
n = 100 over 256 lanes (phase 11's, a lane's matrices in device memory).
Inputs are seeded planes of Frobenius norm ~0.3 per lane. Every time is the
mean of back-to-back launches between CUDA events. Bounds are
``chip_smoke``'s: FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s;
for complex128 both the FP64 tensor cores' 67 and the FP64 FMA pipes' 34.

Without arguments: each kernel's launch shape (lanes per block, threads per
lane, threads, blocks, warps resident per SM), the compiler's registers and
spills for the instantiation launched (the library this run loaded), B6 at
order 1 (loads, one squaring, stores) beside order 12, each time beside its
bound, its plain version and, where one PyTorch call computes the same
function, that call (``torch.linalg.matrix_exp`` for B6; for B7 the upper
right block of ``matrix_exp([[X^H, G], [0, X^H]])``, the Frechet derivative
of exp at X^H in the direction G; ``torch.einsum`` for B10).

With ``--ab DIR`` it times only the kernels, on the same card in turns: the
package of DIR (another checkout, e.g. the parent commit unpacked with ``git
archive`` into a gitignored directory), this checkout, this checkout, DIR;
each turn is its own process, builds its own library and makes the same
inputs. Run from the root of a checkout:

    python3 scripts/torch_batched_linalg_time.py
    python3 scripts/torch_batched_linalg_time.py --ab build/parent

Needs one NVIDIA GPU and nvcc (about a minute; with ``--ab`` about two).
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
_ARGS.add_argument("--ab", metavar="DIR", help="alternate the kernels with the checkout DIR's")
_ARGS.add_argument("--turn", metavar="DIR", help=argparse.SUPPRESS)
ARGS = _ARGS.parse_args()
# the package under test: this checkout's, or DIR's for one turn of --ab
sys.path.insert(0, str(ROOT))
if ARGS.turn:
    sys.path.insert(0, str(Path(ARGS.turn).resolve()))

from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # this checkout's bounds and helpers, whichever package is timed

ORDER, SQUARINGS = 12, 1
N = 10
EXPM_LANES, BWD_LANES, F64_LANES, MATMUL_LANES = 2_048_000, 256_000, 1_024_000, 1_024_000
WIDE_LANES = 256


def planes(n, lanes, count, seed, dtype=torch.float32):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((count, n, n, lanes), device="cuda", generator=gen, dtype=torch.float64)
    return [p.to(dtype) for p in x * (0.3 / np.sqrt(2 * n * n))]


def expm_work(n, lanes, order=ORDER, squarings=SQUARINGS):
    """(product FLOP, bytes) of B6 over ``lanes`` lanes, complex64."""
    return (order - 1 + squarings) * 8.0 * n**3 * lanes, 16.0 * n * n * lanes


def bwd_work(n, lanes):
    return 3 * (ORDER - 1 + SQUARINGS) * 8.0 * n**3 * lanes, 24.0 * n * n * lanes


def matmul_work(n, lanes):
    return 8.0 * n**3 * lanes, 24.0 * n * n * lanes


def cases():
    """(name, which, n, lanes, planes count, dtype, order, kernel, plain, work)."""
    out = []
    for n, lanes in ((N, None), (65, WIDE_LANES), (100, WIDE_LANES)):
        e = lanes or EXPM_LANES
        out.append((f"B6 n={n} {e} lanes", "expm", n, e, 2, torch.float32, ORDER,
                    lambda p: bl.expm_taylor_bol(*p, ORDER, SQUARINGS),
                    lambda p: bl.expm_taylor_bol_plain(*p, ORDER, SQUARINGS),
                    expm_work(n, e)))
        if n == N:
            out.append((f"B6 n={n} {BWD_LANES} lanes (the gradient's chunks)", "expm", n,
                        BWD_LANES, 2, torch.float32, ORDER,
                        lambda p: bl.expm_taylor_bol(*p, ORDER, SQUARINGS),
                        lambda p: bl.expm_taylor_bol_plain(*p, ORDER, SQUARINGS),
                        expm_work(n, BWD_LANES)))
            out.append((f"B6 n={n} {e} lanes order 1", "expm", n, e, 2, torch.float32, 1,
                        lambda p: bl.expm_taylor_bol(*p, 1, SQUARINGS),
                        lambda p: bl.expm_taylor_bol_plain(*p, 1, SQUARINGS),
                        expm_work(n, e, 1)))
            out.append((f"B6 complex128 n={n} {F64_LANES} lanes", "expm", n, F64_LANES, 2,
                        torch.float64, ORDER,
                        lambda p: bl.expm_taylor_bol(*p, ORDER, SQUARINGS),
                        lambda p: bl.expm_taylor_bol_plain(*p, ORDER, SQUARINGS),
                        expm_work(n, F64_LANES)))
        b = lanes or BWD_LANES
        out.append((f"B7 n={n} {b} lanes", "expm_bwd", n, b, 4, torch.float32, ORDER,
                    lambda p: bl.expm_taylor_bol_bwd(*p, ORDER, SQUARINGS),
                    lambda p: bl.expm_taylor_bol_bwd_plain(*p, ORDER, SQUARINGS),
                    bwd_work(n, b)))
        m = lanes or MATMUL_LANES
        out.append((f"B10 n={n} {m} lanes", "matmul", n, m, 4, torch.float32, 0,
                    lambda p: bl.matmul_bol(*p), lambda p: bl.matmul_bol_plain(*p),
                    matmul_work(n, m)))
    return out


def turn(label):
    """One turn of --ab: each kernel alone at each shape."""
    for name, _, n, lanes, count, dtype, _, kernel, _, _ in cases():
        p = planes(n, lanes, count, seed=n + count, dtype=dtype)
        ms = smoke.cuda_ms(torch, lambda: kernel(p), reps=5)
        print(f"{name}: {ms:.3f} ms, {label}", flush=True)
        del p
        torch.cuda.empty_cache()


def library(which, p):
    """The one PyTorch call that computes the kernel's function, and the view
    of the kernel's output it is compared with."""
    if which == "expm":
        stack = bl.from_bol(*p).contiguous()
        return lambda: torch.linalg.matrix_exp(stack), lambda out: bl.from_bol(*out)
    if which == "matmul":
        a, b = torch.complex(p[0], p[1]), torch.complex(p[2], p[3])
        return lambda: torch.einsum("ikb,kjb->ijb", a, b), lambda out: torch.complex(*out)
    return smoke.block_expm_vjp(torch, bl, p), lambda out: bl.from_bol(*out)


def by_part():
    for name, which, n, lanes, count, dtype, order, kernel, plain, work in cases():
        p = planes(n, lanes, count, seed=n + count, dtype=dtype)
        _, shape_text = smoke.bl_launch(bl, which, n, lanes, double=dtype == torch.float64)
        out = kernel(p)
        ms = smoke.cuda_ms(torch, lambda: kernel(p), reps=5)
        plain_ms, ref = smoke.timed_ms(torch, lambda: plain(p))
        diff = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        del ref
        flops, nbytes = work
        if dtype == torch.float64:
            tc = smoke.bound_f64(flops, 0.0, 2 * nbytes)
            fma = smoke.bound(flops, 2 * nbytes, smoke.PEAK_F64)
            bound_text = (f"bounds {tc[0]:.3f} ms (FP64 tensor cores, {tc[1]}) and {fma[0]:.3f} "
                          f"ms (FP64 FMA pipes, {fma[1]})")
        else:
            b = smoke.bound(flops, nbytes)
            bound_text = f"bound {b[0]:.3f} ms ({b[1]}; the kernel at {b[0] / ms:.0%} of it)"
        lib_text = ""
        if order == ORDER or which == "matmul":
            call, view = library(which, p)
            call()
            lib_ms, lib_out = smoke.timed_ms(torch, call)
            lib_diff = float((view(out) - lib_out).abs().max())
            lib_text = f", library {lib_ms:.3f} ms (differs from the kernel by {lib_diff:.2e})"
            del lib_out
        print(f"{name}: kernel {ms:.3f} ms, {bound_text}, plain {plain_ms:.1f} ms{lib_text}, "
              f"kernel vs plain {diff:.2e}; launch: {shape_text}", flush=True)
        del p, out
        torch.cuda.empty_cache()


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
