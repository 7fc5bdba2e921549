#!/usr/bin/env python3
"""Times of the batched_linalg kernels at the Magnus row's shapes, on the card.

The batched Taylor expm (2,048,000 lanes of n = 10, order 12, one squaring), its
backward (256,000 lanes) and the batched product (1,024,000 lanes), each
beside its bound (the larger of operations over 67 TFLOP/s and bytes over 3.35
TB/s) and its plain version, CUDA events over a few launches. Used to compare
versions of ``csrc/batched_linalg.cu``: run it on each version within one call
on one card. Needs one NVIDIA GPU and nvcc.

    python scripts/torch_batched_linalg_time.py [n]
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl  # noqa: E402

PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
ORDER, SQUARINGS = 12, 1


def cuda_ms(fn, reps=5):
    fn()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def planes(n, lanes, count, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((count, n, n, lanes), device="cuda", generator=gen)
    return list(x * (0.3 / np.sqrt(2 * n * n)))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; n = {n}, order {ORDER}, {SQUARINGS} squaring", flush=True)
    cases = (
        ("expm_taylor_bol", 2_048_000, 2, (ORDER - 1 + SQUARINGS) * 8.0 * n**3, 16.0 * n * n,
         lambda p: bl.expm_taylor_bol(*p, ORDER, SQUARINGS),
         lambda p: bl.expm_taylor_bol_plain(*p, ORDER, SQUARINGS)),
        ("expm_taylor_bol_bwd", 256_000, 4, 3 * (ORDER - 1 + SQUARINGS) * 8.0 * n**3,
         24.0 * n * n,
         lambda p: bl.expm_taylor_bol_bwd(*p, ORDER, SQUARINGS),
         lambda p: bl.expm_taylor_bol_bwd_plain(*p, ORDER, SQUARINGS)),
        ("matmul_bol", 1_024_000, 4, 8.0 * n**3, 24.0 * n * n,
         lambda p: bl.matmul_bol(*p), lambda p: bl.matmul_bol_plain(*p)),
    )
    for name, lanes, count, flops, nbytes, kernel, plain in cases:
        p = planes(n, lanes, count, seed=lanes % 97)
        out, ref = kernel(p), plain(p)
        diff = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        del out, ref
        ms, plain_ms = cuda_ms(lambda: kernel(p)), cuda_ms(lambda: plain(p), reps=1)
        bound_ms = max(flops * lanes / PEAK_F32, nbytes * lanes / PEAK_BYTES) * 1e3
        print(f"{name}: {lanes} lanes: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, kernel vs plain {diff:.2e}", flush=True)
        del p
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
