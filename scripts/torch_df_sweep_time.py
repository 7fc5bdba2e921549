#!/usr/bin/env python3
"""Kernel B8 (the FP64 Magnus sweep) alone on the card, by part of its work.

At the shape of the df32 CR row of ``chip_smoke.py`` phase 15 (n = 16, k = 2,
10,000 members in launches of 2,048, 500 steps) this times the kernel with
CUDA events over seeded inputs in five configurations, so that the
differences split its time between the Magnus rule's products and the Horner
action: Magnus-3 with the one-product commutator at Taylor order 12 (the
row), the same at order 1, Magnus-3 without the shortcut, and Magnus-2 with
and without it. It prints one line per configuration with the time, the
bound (the matrix products over the FP64 tensor cores' 67 TFLOP/s, the rest
over 34 TFLOP/s) and their ratio, and the card's name and power limit.

    python scripts/torch_df_sweep_time.py

Needs one NVIDIA GPU.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs  # noqa: E402

N, K, MEMBERS, STEPS, CHUNK = 16, 2, 10_000, 500, 2048
CONFIGS = ((3, True, 12), (3, True, 1), (3, False, 12), (2, True, 12), (2, False, 12))


def inputs(magnus_order, hermitian, order):
    gen = np.random.default_rng(7)

    def anti_hermitian(scale):
        a = gen.normal(size=(N, N)) + 1j * gen.normal(size=(N, N))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(N))

    w = gen.uniform(0.0, 200.0, N)
    nodes = len(dfs.MAGNUS_NODES[magnus_order])
    y0 = gen.normal(size=(N, MEMBERS)) + 1j * gen.normal(size=(N, MEMBERS))
    return dfs.prepare_df_inputs(
        anti_hermitian(2.0), np.stack([anti_hermitian(1.0) for _ in range(K)]),
        w[None, :] - w[:, None], gen.normal(size=(STEPS, nodes, K, MEMBERS)) * 0.1,
        torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device="cuda"), 0.2,
        magnus_order=magnus_order, order=order, hermitian=hermitian,
    )


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for magnus_order, hermitian, order in CONFIGS:
        x = inputs(magnus_order, hermitian, order)
        ms = smoke.cuda_ms(torch, lambda x=x: dfs._launch_kernel(x, CHUNK), reps=3)
        bound_ms, _ = smoke.df_bound(x)
        print(f"B8 Magnus-{magnus_order} hermitian={hermitian} order {order}: {ms:.3f} ms "
              f"({MEMBERS} x n = {N} x {STEPS} steps, launches of {CHUNK}), bound "
              f"{bound_ms:.3f} ms, {ms / bound_ms:.1f}x", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
