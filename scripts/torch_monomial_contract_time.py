#!/usr/bin/env python3
"""Kernel B11 (``csrc/monomial_contract.cu``) alone on one GPU.

The shapes are the Dysolve cells' (``BENCHMARK.json`` cells ``dyson_sweep``
and ``magnus_sweep``): n = 10 over 2,048,000 lanes (1,000 steps of 2,048
members), 4 Chebyshev variables; Dyson 6 (209 terms and a constant term,
complex64 output for the chain B5) and Magnus 3 (34 terms, float32 planes for
the Taylor expm B6). The expansions are seeded arrays of the cells' sizes,
not the transmon's (the time does not depend on the values).

For each shape: the launch at every count of entries a thread (TE = 2, 4, 8, 10;
warps, tiles, shared memory; the default marked), the compiler's registers
and spills for each instantiation, the kernel's time (mean of back-to-back
launches between CUDA events) beside its bound (``portbench/counts/
roofline.py``: FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s), and
the plain version (the monomial table, ``addmm`` and, for Dyson, the complex
copy: the path the kernel replaced) as its yardstick, with the largest gap
between the two over the largest output entry. Run from the root of a
checkout:

    python3 scripts/torch_monomial_contract_time.py

Needs one NVIDIA GPU and nvcc (about a minute). Ends with one JSON line.
"""
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.counts import roofline  # noqa: E402
from qiskit_dynamics_tpu_torch.ops import monomial_contract as mc  # noqa: E402
from qiskit_dynamics_tpu_torch.perturbation import ArrayPolynomial  # noqa: E402

N, N_VARS, LANES = 10, 4, 2_048_000
SHAPES = (("dyson", 6, True), ("magnus", 3, False))  # method, expansion order, constant term


def expansion(order, constant, seed=0):
    labels = [list(ms) for d in range(1, order + 1)
              for ms in itertools.combinations_with_replacement(range(N_VARS), d)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    planes = torch.randn((2 * N * N, len(labels)), device="cuda", generator=gen) * 0.05
    start = None
    if constant:
        start = torch.zeros((2, N, N), device="cuda")
        start[0] = torch.eye(N, device="cuda")
        start = start.reshape(-1, 1)
    polynomial = ArrayPolynomial(array_coefficients=np.zeros((len(labels), 1)),
                                 monomial_labels=labels)
    return mc.Expansion(polynomial, planes, start, N)


def work(terms):
    """(FLOP, bytes) of one launch: the monomials and the contraction; the
    table read, the expansion read and the output written once."""
    flops = ((terms - N_VARS) + 4.0 * terms * N * N) * LANES
    nbytes = 4.0 * N_VARS * LANES + 8.0 * terms * N * N + 8.0 * N * N * LANES
    return flops, nbytes


def cuda_ms(fn, reps):
    fn()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def ptxas(te):
    """Registers and spills of the instantiation at ``te``."""
    report = Path(mc._LIB.path + ".ptxas.txt").read_text()
    found, take = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            take = f"ILi{te}E" in line
        elif take and ("registers" in line or "spill" in line):
            found.append(line.split(":", 2)[-1].strip())
    return "; ".join(found)


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    coeffs = (torch.rand((N_VARS, LANES), device="cuda", generator=gen) - 0.5) * 0.4
    result = dict(card=card, shapes={})
    for method, order, constant in SHAPES:
        exp = expansion(order, constant)
        terms = exp.planes.shape[1]
        interleaved = method == "dyson"
        bound_s, bound_by = roofline.bound(*work(terms))
        plain_ms = cuda_ms(lambda: mc.contract_monomials_plain(coeffs, exp, interleaved), 3)
        want = mc.contract_monomials_plain(coeffs, exp, interleaved)
        default = mc.launch_shape(N)
        rows = []
        for te in (2, 4, 8, 10):
            shape = mc.launch_shape(N, te)
            n_nodes, chunk = mc.plan(exp, shape, N_VARS)
            smem = shape.smem_bytes(n_nodes, N_VARS, chunk)
            ms = cuda_ms(lambda: mc._launch_kernel(coeffs, exp, interleaved, te=te), 5)
            got = mc._launch_kernel(coeffs, exp, interleaved, te=te)
            diff = float((got - want).abs().max() / want.abs().max())
            del got
            rows.append(dict(te=te, warps=shape.warps, tiles=shape.tiles, nodes=n_nodes,
                             chunk=chunk, smem_bytes=smem, default=shape == default, ms=ms,
                             roofline_pct=100.0 * bound_s * 1e3 / ms, rel_diff=diff,
                             ptxas=ptxas(te)))
            print(f"{method} ({terms} terms, {LANES} lanes) TE={te} warps={shape.warps} "
                  f"tiles={shape.tiles} nodes={n_nodes} chunk={chunk} smem={smem}"
                  f"{' (default)' if rows[-1]['default'] else ''}: "
                  f"{ms:.3f} ms, {rows[-1]['roofline_pct']:.1f}% of the bound {bound_s * 1e3:.3f} ms "
                  f"({bound_by}); vs plain {diff:.2e}; ptxas {rows[-1]['ptxas']}", flush=True)
        print(f"{method}: plain version (table, addmm{', complex copy' if interleaved else ''}) "
              f"{plain_ms:.3f} ms", flush=True)
        del want
        torch.cuda.empty_cache()
        result["shapes"][method] = dict(terms=terms, lanes=LANES, bound_ms=bound_s * 1e3,
                                        bound_by=bound_by, plain_ms=plain_ms, kernel=rows)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
