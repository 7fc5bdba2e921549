#!/usr/bin/env python3
"""Time the Horner kernel's two variants against its plain version on one GPU.

For four shapes (members x n), order 8, random planes of norm ~0.5: the
cluster-resident kernel (the route ``horner_apply_bm`` takes wherever the
matrix fits in a cluster's shared memory), the streaming kernel forced at the
same shape, and ``horner_twin_bm`` (batched ``torch.matmul``), each as the mean
of 10 back-to-back launches between CUDA events, with the byte bound (each
matrix read once at 3.35 TB/s) and the kernel's largest difference from the
plain version. Run from the root of a checkout:

    python scripts/torch_horner_ab.py
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp  # noqa: E402

SHAPES = ((2048, 256), (10240, 64), (2048, 100), (512, 320))
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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.manual_seed(0)
    for members, n in SHAPES:
        scale = 0.5 / n**0.5
        planes = [torch.randn(members, n, n, device="cuda") * scale for _ in range(2)]
        planes += [torch.randn(members, n, device="cuda") for _ in range(2)]
        resident = event_ms(lambda: hp._launch_kernel(*planes, ORDER))
        streaming = event_ms(lambda: hp._launch_kernel(*planes, ORDER, force_stream=True))
        plain = event_ms(lambda: hp.horner_twin_bm(*planes, order=ORDER))
        ur, _ = hp._launch_kernel(*planes, ORDER)
        plain_r, _ = hp.horner_twin_bm(*planes, order=ORDER)
        cluster = hp._kernel_lib().horner_apply_cluster(n)
        print(f"B={members} n={n} cluster={cluster}: resident {resident:.3f} ms, streaming "
              f"{streaming:.3f} ms, plain {plain:.3f} ms, bound "
              f"{8 * members * n * n / PEAK_BYTES * 1e3:.3f} ms, diff "
              f"{float((ur - plain_r).abs().max()):.2e}")


if __name__ == "__main__":
    main()
