#!/usr/bin/env python3
"""Kernel B8 (the FP64 Magnus sweep, ``csrc/df_magnus_sweep.cu``) alone on one GPU.

Inputs are seeded (numpy): anti-Hermitian frame-basis operators (k = 2), an
antisymmetric frame matrix, coefficients at the Gauss nodes and unit-norm
states, at the shape of the df32 CR row of ``chip_smoke.py`` phase 15 (n = 16,
10,000 members in launches of 2,048, 500 steps of dt = 0.2). Every time is the
mean of back-to-back calls of the wrapper's launch (the table kernel and the
sweep launches) between CUDA events; the bound is ``chip_smoke.df_bound``
(the matrix products over the FP64 tensor cores' 67 TFLOP/s, the rest over
34 TFLOP/s).

Without arguments, by part:

- the compiler's report (registers and spills of each instantiation), the
  count of DMMA instructions (FP64 tensor-core products) in the built
  library's SASS, and the members (one warp each) resident per SM at the row;
- five configurations at the row, whose differences split the time between
  the rule's products, the Horner action and the rest: Magnus-3 with the
  one-product commutator at Taylor order 12 (the row) and at order 1,
  Magnus-3 without the shortcut, Magnus-2 with and without it; each in both
  table layouts (the frame-rotated operators, which the row takes, and the
  (cos, sin) table);
- the Chebyshev 1-d row's launch shape (17 members x 500 steps) with the
  kernel against its plain version, and n = 27 and 32 at 2,048 members.

With ``--ab DIR`` it times only the kernel, at the five configurations and
those three shapes, on the same card in turns: the package of DIR (another
checkout, e.g. the parent commit unpacked with ``git archive`` into a
gitignored directory), this checkout, this checkout, DIR; each turn is its
own process, builds its own kernel and makes the same seeded inputs. Run from
the root of a checkout:

    python3 scripts/torch_df_sweep_time.py
    python3 scripts/torch_df_sweep_time.py --ab build/parent

Needs one NVIDIA GPU (under a minute; with ``--ab`` about two).
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

from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)  # this checkout's bound, whichever package is timed

N, K, MEMBERS, STEPS, CHUNK = 16, 2, 10_000, 500, 2048
CONFIGS = ((3, True, 12), (3, True, 1), (3, False, 12), (2, True, 12), (2, False, 12))
# (name, n, members): Magnus-3 with the shortcut, order 12, 500 steps
SHAPES = (("Chebyshev 1-d launch", 16, 17), ("n = 27", 27, 2048), ("n = 32", 32, 2048))


def inputs(magnus_order, hermitian, order, n=N, members=MEMBERS):
    gen = np.random.default_rng(7 + n)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    w = gen.uniform(0.0, 200.0, n)
    nodes = len(dfs.MAGNUS_NODES[magnus_order])
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    return dfs.prepare_df_inputs(
        anti_hermitian(2.0), np.stack([anti_hermitian(1.0) for _ in range(K)]),
        w[None, :] - w[:, None], gen.normal(size=(STEPS, nodes, K, members)) * 0.1,
        torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device="cuda"), 0.2,
        magnus_order=magnus_order, order=order, hermitian=hermitian,
    )


def line(name, x, ms):
    bound_ms, _ = smoke.df_bound(x)
    return (f"B8 {name} ({x.batch} x n = {x.n} x {x.steps} steps, launches of {CHUNK}): "
            f"{ms:.3f} ms, bound {bound_ms:.3f} ms, {ms / bound_ms:.1f}x")


def config_name(magnus_order, hermitian, order):
    return f"Magnus-{magnus_order} hermitian={hermitian} order {order}"


def turn(label):
    """One turn of --ab: the kernel at CONFIGS and SHAPES."""
    for cfg in CONFIGS:
        x = inputs(*cfg)
        ms = smoke.cuda_ms(torch, lambda: dfs._launch_kernel(x, CHUNK), reps=3)
        print(line(config_name(*cfg), x, ms) + f", {label}", flush=True)
        del x
    for name, n, members in SHAPES:
        x = inputs(3, True, 12, n=n, members=members)
        ms = smoke.cuda_ms(torch, lambda: dfs._launch_kernel(x, CHUNK), reps=3)
        print(line(name, x, ms) + f", {label}", flush=True)
        del x


def by_part():
    lib = dfs._LIB
    report = Path(lib.path + ".ptxas.txt")
    lines = report.read_text().splitlines() if report.exists() else []
    print("ptxas: " + " | ".join(
        line.strip() for line in lines
        if "entry function" in line or "registers" in line or "spill" in line), flush=True)
    shape = dfs.launch_shape(N, K, 3, True, CHUNK)
    blocks = lib.df_magnus_sweep_active_blocks(N, K, 3, 1, shape.members_per_block)
    print(f"B8 at the row: {smoke.sass_count(lib.path, 'DMMA')} DMMA instructions in the "
          f"library's SASS; {shape.members_per_block} member(s) per block, {blocks} blocks "
          f"resident per SM = {blocks * shape.members_per_block} members and warps per SM "
          f"(shared-memory reckoning {shape.members_per_sm}, {shape.smem_bytes} B per block); "
          f"table layout {'rotated' if dfs.rotated_tables(N, K, 3, STEPS) else '(cos, sin)'}",
          flush=True)
    for cfg in CONFIGS:
        x = inputs(*cfg)
        times = {rotated: smoke.cuda_ms(
            torch, lambda r=rotated: dfs._launch_kernel(x, CHUNK, rotated=r), reps=3)
            for rotated in (True, False)}
        print(line(config_name(*cfg), x, times[True])
              + f"; with the (cos, sin) table {times[False]:.3f} ms", flush=True)
        del x
    for name, n, members in SHAPES:
        x = inputs(3, True, 12, n=n, members=members)
        ms = smoke.cuda_ms(torch, lambda: dfs._launch_kernel(x, CHUNK), reps=3)
        extra = ""
        if members < 100:
            plain = dfs.sweep_expm_magnus_df_plain(x)[0]
            diff = float((dfs._launch_kernel(x, CHUNK)[0] - plain).abs().max())
            extra = f", kernel vs plain {diff:.2e}"
        print(line(name, x, ms) + extra, flush=True)
        del x


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
