#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one stdout line each (details of phase 3 go to stderr); any failure
raises and exits non-zero:

1. device: a CUDA device is required; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   reports them.
2. build: compiles the ten kernel sources, the lockstep-adaptive dopri5
   sweep (``qiskit_dynamics_tpu_torch/csrc/adaptive_sweep.cu``), the fixed-step
   Magnus-2 sweep (``csrc/sweep_magnus2.cu``), the member-major Magnus-2/3
   sweep (``csrc/member_sweep.cu``), the Horner expm action
   (``csrc/horner_apply.cu``), the streamed propagator chain
   (``csrc/chain_apply.cu``), the batched product, Taylor expm and expm
   backward (``csrc/batched_linalg.cu``), the FP64 Magnus sweep
   (``csrc/df_magnus_sweep.cu``, and ``csrc/df_magnus_wide.cu`` above n =
   32), the fused expm chain
   (``csrc/expm_chain.cu``) and the perturbative step's monomials and
   contraction (``csrc/monomial_contract.cu``), one nvcc each, in parallel.
3. kernel against its eager twin on the card, in every mode (constant
   envelopes with padded lanes, envelope tables, eval times, budget
   exhaustion, stall guard) at n = 4, 9, 16, 27, 33, 64 (tile_b = 256): final
   states within 1e-5, equal accepted-step counts per tile, step sizes
   within 1e-5 relative, NaN in the same tiles; then the main row's
   tile_b = 512 at n = 16 with each tile forced over clusters of 1, 2, 4, 8
   and 16 blocks (fewer than 8 run several members per lane group), constant
   and table modes: states and step records equal to the twin's bit for bit.
4. the main path at full width: ``cr_solver()`` (n = 16) through
   ``Solver.solve_sweep(method="fused_dopri5")`` over 10,000 amplitudes,
   T = 100, atol = rtol = 1e-6, h0 = 0.1; three probe members against the
   port's float64 DOP853 (atol = rtol = 1e-8) within 1e-5 in population;
   the kernel launch counter must rise; sims/s from a steady block of at
   least 1 s and 3 repeats; the kernel's and the twin's time at that shape,
   and the accepted-step record from which the kernel's bound is computed;
   the kernel's launch shape (cluster G, lanes P and rows R per member,
   threads), the clusters the card co-schedules, its ptxas registers and
   spills, and its time per step (over the slowest tile's steps, rejected
   ones included).
5. the fixed-step kernel against its plain version on the card, in every
   mode (matrix, matrix_herm, matvec) at n = 4, 9, 16, 25, with padded lanes
   and a ragged last block, plus a trajectory (eval_slots) case: states
   within 1e-5 (norm-1 states; the kernel fuses multiply-adds, so the two
   agree to float32 roundoff; bit-for-bit equality is reported, not
   required); the kernel's launch at each n (lanes per member, members per
   warp, warps per block, warps resident per SM, registers) and its ptxas
   line. Phases 6 and 7 print the launch of their row too.
6. the CR sweep gradient at full width: ``cr_solver(device="cuda")``
   (n = 16) through ``Solver.solve_sweep(method="fused_magnus2")`` over
   10,000 amplitudes, T = 100, max_dt = 0.5 (200 steps), loss
   ``mean(|y[:, 1]|^2)``: forward sims/s and grad-sims/s from steady blocks;
   the kernel's launch counter must rise; at members 0, 5,000 and 9,999 the
   forward states within 2e-6 and the gradient within 1e-4 of max |g| of the
   complex128 eager engine (same polynomial) and its autograd gradient.
7. the Lindblad density-matrix sweep (BASELINE config 3): a driven qubit
   with amplitude damping, vectorized (solve_dim 4), 10,240 amplitudes,
   T = 20, max_dt = 0.02 (1,000 steps) through ``solve_sweep``; three probes
   within 1e-5 of the port's float64 DOP853 (atol = rtol = 1e-10).
8. the member-sweep and Horner kernels against their plain versions on the
   card: member sweep with Magnus-2 and Magnus-3, ``hermitian`` on and off,
   at n = 8, 33, 37, 64, Magnus-3 also at 63 and Magnus-2 also at 96, 100,
   128 (33, 37, 63 are ragged for its 16-row MMA tiles), 37 members, 5
   steps; Horner at
   n = 33, 64, 96, 100, 200, 256 (the resident kernel: persistent clusters
   of 1 to 4 blocks, 33 unaligned, 200 split unevenly over four blocks) and
   512 (streaming kernel), orders 8 and 12,
   37 members (a ragged last round of the persistent walk), 67 members at
   n = 256 (two rounds and a ragged third), n = 1,100 (3 members) and 2,048
   (2), past the kernel's old cap of 1,024, and the streaming kernel forced
   at n = 256. Both kernels fuse
   multiply-adds and sum in their own order (the member sweep's products
   in 3xTF32 on the tensor cores), so they agree with ``torch.matmul`` to
   float32 roundoff: within 1e-5 on norm-1 states. Then the member sweep at
   four bracket-dominated cases (n = 37, 64 for both rules, generators of
   norm ~20, steps of 0.1) against the plain version in complex128 within
   5e-6, which float32 products meet and single-pass TF32 products fail.
9. the Lindblad dim-8 sweep at full width (a driven 8-level transmon with
   amplitude damping, vectorized, solve_dim 64, 10,240 amplitudes, T = 20)
   through ``solve_sweep(method="fused_magnus2")`` with ``sweep_engine``
   left at "auto", which must launch the member-sweep kernel: Magnus-3 at
   max_dt = 0.05 (400 steps) within 4e-6 and Magnus-2 at max_dt = 0.02
   (1,000 steps) within 2.5e-6 of the port's float64 DOP853
   (atol = rtol = 1e-12) at members 0, 5,120 and 10,239. Per row the
   kernel's time beside both bounds (products in 3xTF32 on the tensor
   cores, which the kernel is held to, and everything at the FP32 rate),
   its time at Horner order 1 and, at Magnus-2, with ``hermitian`` on the
   same inputs (the part split), and its blocks per SM.
10. the Lindblad dim-256 sweep at full width (two 4-level transmons with
   amplitude damping, vectorized, solve_dim 256, 2,048 amplitudes, T = 10,
   max_dt = 0.08: 125 steps, Magnus-3) through ``sweep_engine="poly"``,
   whose ``poly_horner="auto"`` must launch the Horner kernel once per step:
   members 0 and 2,047 within 2e-6 of DOP853 (1e-12); the einsum route and
   the eager engine are timed once each beside it. The kernel's time at
   Horner order 1 beside order 8 (the part split), its byte and operation
   bounds, the clusters the card co-schedules and its ptxas report.

11. the chain, batched product, Taylor expm and expm backward kernels against
   their plain versions on the card, on unit-norm inputs: n = 2, 4, 10, 16, 32,
   48 (the wide paths: two rows per thread in the chain, one lane per block
   in the others), 37 and 1,000 lanes, chains of 1 and 7 steps, expm orders 8
   and 12 with 0, 1 and 2 squarings; the expm and its backward also at the
   unaligned n = 1, 3, 7, 11, 13, 17, 33 on 1, 7 and 33 lanes (ragged lane
   groups of the lane kernels, n <= 16, and of the tiled ones). The chain
   kernel is built without multiply-add contraction and must agree bit for
   bit; the others within 1e-5 (the backward relative to max(max |g|, 1));
   every case's launch counters must rise.
   Past n = 64, at n = 65 and 100 (a lane's matrices in device memory above
   98), the four ops and the gradients of the ``_ad`` forms, and at n = 65
   ``DysonSolver``/``MagnusSolver.solve_sweep`` of a seeded expansion, run
   the kernels: within float32 roundoff (1e-5) of the CPU's plain versions,
   each kernel's launch counter rising. At n = 100 over 256 lanes each
   kernel's time beside its plain version, its bound and the one PyTorch
   call that computes it (``torch.einsum``, ``torch.linalg.matrix_exp``, and
   for the backward ``matrix_exp`` of the block ``[[X^H, G], [0, X^H]]``).
12. the Dyson row of BASELINE config 4 at full width:
   ``dyson_transmon_solver(device="cuda")`` (dim 10, nu = 5, alpha = -0.33,
   r = 0.02, dt = 0.1, Chebyshev order 1, Dyson order 6) through
   ``solve_sweep`` over 2,048 Gaussian amplitudes in [0.2, 1.0] (sigma = T/6,
   centred at T/2), 1,000 steps, y0 = e_0; the chain kernel's and the
   monomial_contract kernel's (B11) launch counters must rise once; B11 at
   the row's shape (2,048,000 lanes, 209 terms) beside its bound and its plain
   version (the monomial table and addmm it replaced, its library yardstick),
   within 1e-5 of the largest entry; members 0, 1,023 and 2,047 within 1e-5 in max | |y| - |ref| |
   of the port's host DOP853 (atol = rtol = 1e-12) rotated into the frame
   (the forward's rate is the benchmark cell ``dyson_sweep``'s, not timed
   here); then the gradient of ``sum(|y[:, 1]|^2) / B``
   over 8 checkpointed chunks of 256: grad-sims/s, and at the probes the
   gradient within 1e-4 of max |g| of the complex128 plain route's autograd
   gradient (computed on the host).
13. the Magnus row at full width: ``magnus_transmon_solver(device="cuda")``
   (Magnus order 3, one squaring; the forward's rate: the cell
   ``magnus_sweep``), the same sweep and bars (B11 at 34 terms, float32
   planes out): the expm kernel
   must launch once per call over 2,048,000 lanes and the chain kernel after
   it; in the gradient the expm backward kernel must launch 8 times over
   256,000 lanes. ``torch.linalg.matrix_exp`` is timed beside the expm
   kernel, and ``matrix_exp`` of the block ``[[X^H, G], [0, X^H]]`` (its
   upper right block is the VJP of exp) beside the backward; both kernels'
   launch shapes (lanes per block, threads per lane, blocks, warps resident
   per SM) and ptxas registers and spills are printed. The batched product's
   entry point is driven once at full width
   on this row's propagators (consecutive steps composed pairwise, 1,024,000
   lanes) beside ``torch.einsum``.

14. the FP64 kernels against their plain versions on the card, unit-norm
   states: the Magnus sweep B8 at n = 2, 4, 5, 9, 13, 16, 27, 31, 32,
   Magnus-2 and -3, ``hermitian`` on and off, a uniform grid and a
   non-uniform one with trajectory slots, 37 members in launches of 16 (a
   ragged last launch and block); 1, 17 and 2,049 members (one past a full
   chunk) at n = 16; node times near 330, so that the phase arguments reach
   ~1e4 rad; n = 32 over 300 steps, where the call takes the (cos, sin)
   table: all within 1e-12; the chain in complex128 bit for bit and the
   Taylor expm in complex128 within 1e-12, at phase 11's shapes. Past n =
   32 B8 takes its one-block-per-member sweep: at n = 33 and 46 (planes in
   device memory above 45), and ``fused_sweep_solve(precision="df32")`` of a
   vectorized dim-6 Lindblad model (solve_dim 36), within 1e-12 of the CPU's
   plain version, B8's counter rising.
15. the df32 CR rows at full width: ``cr_solver()`` (n = 16, frame diag(H0),
   RWA) through ``Solver.solve_sweep(method="fused_magnus2",
   precision="df32")`` over 10,000 amplitudes, T = 100, max_dt = 0.2 (500
   steps of Magnus-3, Taylor order 12): B8 must launch; the complex states
   at members 0, 4,999 and 9,999 within 1e-8 of the port's host DOP853
   (atol = rtol = 1e-12); sims/s from a steady block; B8 alone and its plain
   version at that shape, its members (warps) resident per SM and the count
   of DMMA (FP64 tensor-core) instructions in its library's SASS, which must
   not be 0. Then the Gaussian envelope (width T / 5), 2 probes within 1e-8.
16. the Chebyshev rows: ``solve_sweep(method="chebyshev")`` over the same
   10,000 amplitudes (tol 1e-9, min_level 4, max_dt 0.2; phase 15's
   references), and the 100 x 100 amplitude x detuning map (detuning
   within +-0.002, min_level 3, max_level 7), 3 probes against DOP853(1e-12):
   states within 1e-8, node counts, sims/s.
17. the FP64 Dysolve rows: ``dyson_transmon_solver(chebyshev_order=2,
   expansion_order=5)`` and ``magnus_transmon_solver`` at the order
   ``MAGNUS_DF`` names, ``solve_sweep(precision="df32", df_chunk_b=1024)``
   over phase 12's 2,048 Gaussian amplitudes and 1,000 steps: the complex
   states at the probes within 1e-8 of phase 12's references; the
   complex128 chain (and for Magnus the complex128 expm) kernels must launch
   once per pass of 1,024 members, and are timed alone beside their plain
   versions (and ``torch.linalg.matrix_exp``); the complex128 expm's bound
   on the FP64 FMA pipes, where it runs its products, beside the one on the
   FP64 tensor cores, and its launch shape.
18. the fused expm chain (kernel B9) at bench.py's cell: T = 64, b = 8,
   n = m = 256, y0 = I, dt = 0.9, ||G|| = 2 (anti-Hermitian), order 12, 1
   squaring, complex64, through ``benchmarks.expm_chain``: B9 must launch
   once per ``engine="pallas"`` call; both engines timed as steady blocks
   (us per expm+apply), their checksum ``sum |y|`` within 1e-5 relative, B9
   against its plain version within 1e-4 on the unitary columns, and at
   n = 100 (complex64, 2e-5) and n = 64 in complex128 (1e-12); the kernel's
   time beside its bound, its plain version and the cuBLAS loop.
19. the solver surface on the card: phase 4's CR ``Solver`` (n = 16, frame,
   RWA) solved once over T = 100 with ``tpu_dopri5`` and ``tpu_dop853`` (tol
   1e-8), ``jax_expm`` (Taylor, Magnus-2, max_dt 0.01) and
   ``jax_RK4_parallel`` (max_dt 0.01): results stay on the card; populations
   within 1e-7 (adaptive) and 1e-9 (fixed-step) of the host DOP853 (1e-10);
   time and step counts.

Earlier paths keep their widths; only their depth may be cut if the whole run
nears its time limit (none is cut today).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from portbench.counts import adaptive_dopri5, magnus_member, roofline
from portbench.counts.roofline import PEAK_F32, PEAK_F64, PEAK_TF32

SWEEP = 10_000
T_MAIN = 100.0
AMP_SCALE = 0.02
PROBES = 3
MAIN_TOL = 1e-6
MODE_TOL = 1e-3
DIMS = (4, 9, 16, 27, 33, 64)
B1_CLUSTERS = (1, 2, 4, 8, 16)  # phase 3's forced cluster sizes at the main row's tile_b
B2_DIMS = (4, 9, 16, 25)
B2_MODES = ("matrix", "matrix_herm", "matvec")
B2_TOL = 1e-5
GRAD_SWEEP = 10_000
GRAD_MAX_DT = 0.5
FWD_TOL = 2e-6  # f32 kernel vs complex128 engine, same polynomial (CPU: 1.9e-7)
GRAD_TOL = 1e-4  # relative to max |g|
LIND_SWEEP = 10_240
LIND_T = 20.0
LIND_MAX_DT = 0.02
LIND_TOL = 1e-5
B3_TOL = 1e-5  # member sweep and Horner kernels vs torch.matmul: float32 roundoff
# phase 8's B3 dims: 33, 37 and 63 are ragged for the kernel's 16-row MMA tiles
B3_DIMS2 = (8, 33, 37, 64, 96, 100, 128)
B3_DIMS3 = (8, 33, 37, 63, 64)
# phase 8's bracket-dominated B3 cases, (magnus, n): anti-Hermitian generators of
# spectral radius ~20 and steps of 0.1, so the brackets' products carry much of
# each step matrix. The kernel is held against the plain version in complex128:
# float32 with the products in 3xTF32 reads a few 1e-7 there, single-pass TF32
# products ~7e-5 (a CPU emulation; the card readings are in PERF.md).
B3_BRACKET_CASES = ((2, 37), (2, 64), (3, 37), (3, 64))
B3_BRACKET_TOL = 5e-6
# phase 8's B4 cases, (n, order, members, streaming forced): the resident
# kernel up to n = 256 (33 unaligned; 200 split unevenly over four blocks),
# 37 members (a ragged last round of the persistent walk) and 67 at n = 256
# (two rounds of the 30 clusters an H100 co-schedules there, and 7 more);
# the streaming kernel at 512 and past the old cap of 1,024 (1,100 and
# 2,048), and forced at 256
B4_CASES = tuple(
    (n, order, 37, False) for n in (33, 64, 96, 100, 200, 256, 512) for order in (8, 12)
) + ((256, 8, 67, False), (1100, 8, 3, False), (2048, 8, 2, False), (256, 8, 37, True))
L8_SWEEP = 10_240
L8_T = 20.0
L8_ROWS = ((3, 0.05, 4e-6), (2, 0.02, 2.5e-6))  # (magnus_order, max_dt, limit vs DOP853 1e-12)
L256_SWEEP = 2_048
L256_T = 10.0
L256_MAX_DT = 0.08
L256_TOL = 2e-6
PT_DIM, PT_NU, PT_ALPHA, PT_R, PT_DT = 10, 5.0, -0.33, 0.02, 0.1
PT_STEPS = 1_000
PT_SWEEP = 2_048
PT_CHUNKS = 8
PT_TOL = 1e-5  # dyson_max_err and magnus_max_err against DOP853(1e-12)
PT_KERNEL_TOL = 1e-5  # batched_linalg kernels vs torch.einsum: float32 roundoff
# monomial_contract vs its plain version (the table and a cuBLAS addmm), of the
# largest entry: float32 sums of up to 209 terms in two orders
B11_TOL = 1e-5
PT_DIMS = (2, 4, 10, 16, 32, 48)
PT_BATCHES = (37, 1000)
PT_EXPM_CASES = ((8, 0), (8, 2), (12, 0), (12, 1), (12, 2))
# the lane kernels (n <= 16) and the tiled ones above them at unaligned n, on
# lane counts that split the lane groups (3 lanes per warp at n = 10) raggedly
PT_LANE_DIMS = (1, 3, 7, 11, 13, 17, 33)
PT_LANE_BATCHES = (1, 7, 33)
# past n = 64 the perturbative kernels against the CPU's plain versions:
# float32 on two devices, each summing in its own order
PAST_64_TOL = 1e-5
DF_DIMS = (2, 4, 5, 9, 13, 16, 27, 31, 32)  # B8 pads n to a multiple of 8
DF_MEMBERS, DF_STEPS = 37, 12  # phase 14's kernel checks: 37 members in launches of 16
# phase 14's member counts at n = 16, default chunks of 2,048: one member; 17
# (one member per block, the Chebyshev row's launch); one past a full chunk
DF_MEMBER_COUNTS = (1, 17, 2049)
DF_KERNEL_TOL = 1e-12  # FP64 kernels vs their plain versions, unit-norm states
DF_SWEEP = 10_000
DF_MAX_DT = 0.2  # 500 steps of Magnus-3 over T_MAIN
DF_TOL = 1e-8  # df32_*, cheb_*, cheb2d_*, dyson_df_* against DOP853(1e-12) (BARS.md)
CHEB_TOL = 1e-9  # the certified interpolation error asked of the Chebyshev rows
CHEB_MAP = 100  # the 2-d map is CHEB_MAP x CHEB_MAP amplitude x detuning points
CHEB_DETUNING = 0.002
DF_CHUNK = 1024  # members per pass of the FP64 Dysolve rows
# the Magnus FP64 Dysolve row's expansion, chosen by scripts/torch_df_truncation.py
MAGNUS_DF = dict(chebyshev_order=2, expansion_order=3)
EC_T, EC_B, EC_N = 64, 8, 256  # phase 18: bench.py's dim-256 expm chain cell
EC_DT, EC_ORDER, EC_SQUARINGS = 0.9, 12, 1
EC_CHECKSUM_TOL = 1e-5  # the two engines' sum |y|, relative (BARS.md:27)
# B9 against its plain version on the unitary columns of the cell, complex64:
# float32 roundoff of 448 chained products, each summed in its own order
EC_PLAIN_TOL = 1e-4
SV_T = 100.0  # phase 19: the CR Solver once over T with each device method
# (method, keywords, bar against the host DOP853 at 1e-10, in population), all
# in complex128: the adaptive methods at tol 1e-8 (their error on the CPU is
# 3.3e-8 and 7.5e-9), the fixed-step ones at max_dt = 0.01 (5.5e-11 and 6.1e-11,
# most of it the reference's own); scripts/torch_solver_truncation.py
SV_METHODS = (
    ("tpu_dopri5", dict(atol=1e-8, rtol=1e-8), 1e-7),
    ("tpu_dop853", dict(atol=1e-8, rtol=1e-8), 1e-7),
    ("jax_expm", dict(max_dt=0.01, magnus_order=2, expm_method="taylor"), 1e-9),
    ("jax_RK4_parallel", dict(max_dt=0.01), 1e-9),
)
B8 = ("df_magnus_sweep_launch", "df_magnus_wide_launch")  # kernel B8's two sweeps


class CheckFailed(RuntimeError):
    """A phase's result is outside its stated bound."""


def check(ok: bool, message: str):
    if not ok:
        raise CheckFailed(message)


def log(message: str):
    print(message, file=sys.stderr, flush=True)


def launched(*entries) -> int:
    """The launches of the kernel entries so far (``kernel.launches.<entry>``)."""
    from qiskit_dynamics_tpu_torch.kernels import launches

    return launches(*entries)


# --------------------------------------------------------------------------
# phase 3 helpers
# --------------------------------------------------------------------------
def kernel_problem(n: int, seed: int):
    """Seeded kernel inputs at state dimension n: a diagonal frame with
    transmon-like frequencies, an anti-Hermitian static coupling with zero
    diagonal, and k = 2 drive operators (the RWA cos/sin pair)."""
    gen = np.random.default_rng(seed)
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))  # frame frequencies (rad/ns)

    def herm(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return scale * (a + a.conj().T) / 2

    static = -1j * herm(1.0)
    np.fill_diagonal(static, 0.0)
    drive = herm(2 * np.pi * 0.2)
    ops = np.stack([-1j * drive, -1j * (1j * np.triu(drive) - 1j * np.tril(drive))])
    omega = w[None, :] - w[:, None]
    freqs = np.full(2, 2 * np.pi * 0.4)
    return static, ops, omega, freqs


def _steps_agree(ref, out):
    """Max relative difference of the accepted steps over all tiles, or a
    failure message: equal accepted-step counts per tile, every step within
    1e-5 relative."""
    worst = 0.0
    for tile, (a, b) in enumerate(zip(ref, out)):
        a, b = a[a > 0], b[b > 0]
        if a.size != b.size:
            return f"tile {tile}: {a.size} vs {b.size} accepted steps"
        rel = np.abs(a - b) / a
        if np.any(rel > 1e-5):
            i = int(np.argmax(rel))
            return f"tile {tile}: step {i} differs by {rel[i]:.2e} relative"
        worst = max(worst, float(np.max(rel, initial=0.0)))
    return worst


def phase_modes(torch, asw, expand_lanes):
    """Kernel against twin in every mode at every n. Returns the max abs diff."""
    cuda = torch.device("cuda")
    T = 2.0
    n_cells = 8
    eval_ts = (0.55, 1.3, 2.0)
    worst_state, worst_step = 0.0, 0.0
    for n in DIMS:
        static, ops, omega, freqs = kernel_problem(n, seed=100 + n)
        gen = np.random.default_rng(n)
        members, tile_b = 1000, 256  # 1000 members pad to 1024 lanes: 4 tiles
        amp = gen.uniform(0.5, 2.0, members) * np.exp(1j * gen.uniform(0, 2 * np.pi, members))
        amps = torch.as_tensor(np.stack([amp, amp * np.exp(-1j * np.pi / 2)]), device=cuda)
        y0 = torch.zeros(n, dtype=torch.complex128, device=cuda)
        y0[0] = 1.0
        lane_amps, y0_cols, _, _ = expand_lanes(amps, y0, n, tile_b)
        cell_t = (np.arange(n_cells) + 0.5) * T / n_cells
        table = lane_amps[:, None, :] * torch.as_tensor(
            np.exp(-((cell_t - 1.0) ** 2)), device=cuda
        )[None, :, None]
        base = dict(tf=T, atol=MODE_TOL, rtol=MODE_TOL, h0=0.1, tile_b=tile_b, max_steps=2048)
        modes = {
            "constant": (lane_amps, {}),
            "table": (table, {"env_dt": T / n_cells}),
            "eval": (table, {"env_dt": T / n_cells, "eval_ts": eval_ts}),
            "budget": (lane_amps, {"max_steps": 6}),
            "stall": (lane_amps, {"atol": 1e-13, "rtol": 1e-13, "max_steps": 24}),
        }
        for mode, (mode_amps, extra) in modes.items():
            kwargs = {**base, **extra}
            args = (static, ops, omega, freqs, mode_amps, y0_cols)
            out, rec = asw.sweep_dopri5_lockstep(*args, record_steps=True, **kwargs)
            torch.cuda.synchronize()
            inputs = asw.prepare_inputs(*args, **kwargs)
            twin, twin_traj, twin_rec = asw.sweep_dopri5_lockstep_plain(inputs, record_steps=True)
            torch.cuda.synchronize()
            final = out[0] if "eval_ts" in extra else out
            pairs = [(final, twin)]
            if "eval_ts" in extra:
                pairs.append((out[1], twin_traj))
            for got, want in pairs:
                got, want = got.cpu().numpy(), want.cpu().numpy()
                check(np.array_equal(np.isnan(got), np.isnan(want)),
                      f"n={n} {mode}: NaN lanes differ between kernel and twin")
                diff = float(np.nanmax(np.abs(got - want), initial=0.0))
                check(diff <= 1e-5, f"n={n} {mode}: kernel vs twin state diff {diff:.2e} > 1e-5")
                worst_state = max(worst_state, diff)
            nan_tiles = np.isnan(final.cpu().numpy()).reshape(n, -1, tile_b).all(axis=(0, 2))
            if mode == "stall":
                check(nan_tiles.all(), f"n={n} stall: forced out-of-tolerance steps must poison")
            if mode == "budget":
                check(nan_tiles.any(), f"n={n} budget: an exhausted budget must poison its tile")
            steps = _steps_agree(rec.cpu().numpy(), twin_rec.cpu().numpy())
            check(not isinstance(steps, str), f"n={n} {mode}: {steps}")
            worst_step = max(worst_step, steps)
            counts = (rec.cpu().numpy() > 0).sum(axis=1).tolist()
            log(f"  n={n:2d} {mode:8s} state diff {diff:.2e}  steps rel {steps:.2e}  "
                f"accepted/tile {counts}  nan tiles {int(nan_tiles.sum())}")
    return worst_state, worst_step


def phase_clusters(torch, asw):
    """B1 at the main row's n = 16 and tile_b = 512 (1,024 members, two tiles)
    forced over clusters of B1_CLUSTERS blocks, constant and table modes:
    states and step records equal to the twin's bit for bit. Returns the
    shapes."""
    cuda = torch.device("cuda")
    n, tile_b, members, T, n_cells = 16, 512, 1024, 2.0, 8
    static, ops, omega, freqs = kernel_problem(n, seed=100 + n)
    gen = np.random.default_rng(n)
    amp = gen.uniform(0.5, 2.0, members) * np.exp(1j * gen.uniform(0, 2 * np.pi, members))
    amps = torch.as_tensor(np.stack([amp, amp * np.exp(-1j * np.pi / 2)]), device=cuda)
    y0 = torch.zeros((n, members), dtype=torch.complex128, device=cuda)
    y0[0] = 1.0
    cell_t = (np.arange(n_cells) + 0.5) * T / n_cells
    table = amps[:, None, :] * torch.as_tensor(np.exp(-((cell_t - 1.0) ** 2)),
                                               device=cuda)[None, :, None]
    modes = {"constant": (amps, {}), "table": (table, {"env_dt": T / n_cells})}
    shapes = []
    for cluster in B1_CLUSTERS:
        shape = asw.shape_for(n, 2, tile_b, cluster)
        shapes.append(shape)
        for mode, (mode_amps, extra) in modes.items():
            inputs = asw.prepare_inputs(static, ops, omega, freqs, mode_amps, y0, tf=T,
                                        atol=MODE_TOL, rtol=MODE_TOL, h0=0.1, tile_b=tile_b,
                                        max_steps=2048, **extra)
            out, _, rec = asw._launch_kernel(inputs, True, shape=shape)
            twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(inputs, record_steps=True)
            torch.cuda.synchronize()
            check(torch.equal(out, twin) and torch.equal(rec, twin_rec),
                  f"B1 at {shape} {mode}: kernel vs twin {float((out - twin).abs().max()):.2e}, "
                  f"step records equal {bool(torch.equal(rec, twin_rec))}")
            log(f"  n=16 tile_b=512 G={cluster} P={shape.lanes} R={shape.rows} "
                f"V={shape.members_per_group} {mode}: bitwise, accepted/tile "
                f"{(rec > 0).sum(dim=1).tolist()}")
    return shapes


def ptxas_entry(report: str, tag: str) -> str:
    """Registers and spills of the kernel entries whose mangled name holds
    ``tag``, from a ``-Xptxas -v`` report."""
    found, take = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            take = tag in line
        elif take and ("spill" in line or "registers" in line):
            found.append(line.split(":")[-1].strip() if "registers" in line else line.strip())
    return "; ".join(found)


# --------------------------------------------------------------------------
# phase 4 helpers
# --------------------------------------------------------------------------
def steady_time(torch, fn, target_s=1.0, min_repeats=3):
    """Per-call seconds from one block of back-to-back calls lasting at least
    ``target_s`` and ``min_repeats`` calls, synchronized only at its two ends.
    A block that ends short is thrown away and timed again, longer."""
    fn()
    torch.cuda.synchronize()
    reps = min_repeats
    while True:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        block = time.perf_counter() - start
        if block >= target_s:
            return block / reps, block, reps
        reps = max(reps + 1, math.ceil(1.2 * reps * target_s / block))


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def timed_ms(torch, fn):
    """Host milliseconds of one synchronized call of ``fn`` and its result."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3, out


def bound(flops: float, nbytes: float, peak: float = PEAK_F32):
    """(bound_ms, bound_by): :func:`portbench.counts.roofline.bound` in ms."""
    seconds, by = roofline.bound(flops, nbytes, peak)
    return seconds * 1e3, by


def bound_f64(product_flops: float, other_flops: float, nbytes: float):
    """(bound_ms, bound_by): :func:`portbench.counts.roofline.bound_f64` in ms."""
    seconds, by = roofline.bound_f64(product_flops, other_flops, nbytes)
    return seconds * 1e3, by


def b2_flops_per_member_step(n: int, k: int, order: int, mode: str) -> float:
    """Float32 operations of one member-step of the fixed-step kernel."""
    build = 2 * n * n * (4 * k + 6)
    if mode == "matvec":
        return build + order * (32 * n * n + 16 * n)
    horner = order * (8 * n * n + 4 * n)
    if mode == "matrix_herm":
        return build + 8 * n**3 + 10 * n * n + horner
    return build + 16 * n**3 + 12 * n * n + horner


def b2_bound(inputs):
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch
    flops = b2_flops_per_member_step(n, k, inputs.order, inputs.mode) * T * B
    nbytes = 4 * (T * 2 * k * B + 4 * n * B + 2 * (k + 1) * n * n) + 8 * n * n
    return bound(flops, nbytes)


def b2_launch(ssw, inputs, warps=None):
    """(shape, text): the launch B2 takes for ``inputs`` (``warps`` per
    block, by default the wrapper's) and a line of its shape, the warps it
    keeps resident per SM, its registers and local bytes, and the ptxas line
    of that instantiation in the library this run loaded."""
    shape = ssw.launch_shape(inputs.n, inputs.k, inputs.mode, inputs.batch, warps=warps)
    report = Path(ssw._LIB.path + ".ptxas.txt")
    if inputs.mode == "matvec" and shape.columns > 16:
        tag = f"sweep_magnus2_wide_matvecILi{shape.columns}E"
    else:
        tag = f"sweep_magnus2_kernelILi{shape.columns}ELb{int(inputs.mode == 'matvec')}E"
    ptxas = ptxas_entry(report.read_text() if report.exists() else "", tag)
    return shape, (
        f"{shape.columns} columns, {shape.lanes_per_member} lanes per member, "
        f"{shape.members_per_warp} members per warp, {shape.warps_per_block} warps per block, "
        f"{shape.blocks} blocks, {shape.smem_bytes} B shared, {shape.blocks_per_sm} blocks = "
        f"{shape.warps_per_sm} warps per SM, {shape.registers} registers, {shape.local_bytes} B "
        f"local; ptxas: {ptxas}")


class Capture:
    """Keeps the arguments of the last kernel launch a wrapper module made on
    one path (only the last: a Horner launch's planes are a gigabyte)."""

    def __init__(self, module):
        self.module, self.last, self._launch = module, None, module._launch_kernel

    def __enter__(self):
        def launch(*args):
            self.last = args
            return self._launch(*args)

        self.module._launch_kernel = launch
        return self

    def __exit__(self, *exc):
        self.module._launch_kernel = self._launch


# --------------------------------------------------------------------------
# phase 5: the fixed-step kernel against its plain version
# --------------------------------------------------------------------------
def phase_b2_modes(torch, ssw, expand_lanes):
    """Kernel against plain version in every mode at every n, padded lanes,
    a ragged last block and a trajectory case. Returns (max diff, all
    bitwise, the launch of each n in ``matrix_herm``). Bit-for-bit equality
    is reported, not required: the kernel fuses multiply-adds."""
    cuda = torch.device("cuda")
    T, dt, t0 = 20, 0.05, 0.3
    members, tile_b = 990, 40  # 990 members pad to 1,000 lanes: a ragged last block
    worst, bitwise, launches = 0.0, True, []
    for n in B2_DIMS:
        static, ops, omega, _ = kernel_problem(n, seed=200 + n)
        gen = np.random.default_rng(300 + n)
        coef = torch.as_tensor(gen.uniform(-1.0, 1.0, (T, 2, 2, members)), device=cuda)
        y0 = gen.normal(size=n) + 1j * gen.normal(size=n)
        y0 = torch.as_tensor(y0 / np.linalg.norm(y0), device=cuda)
        coef, y0_cols, _, _ = expand_lanes(coef.reshape(T * 4, members), y0, n, tile_b)
        coef = coef.reshape(T, 2, 2, -1).float()
        slots = tuple(int(x) for x in np.where(np.arange(T) % 7 == 3, np.arange(T) // 7, -1))
        cases = [(mode, None) for mode in B2_MODES] + [("auto", slots)]
        for mode, eval_slots in cases:
            args = (static, ops, omega, coef, y0_cols)
            kwargs = dict(dt=dt, t0=t0, tile_b=tile_b, hermitian=True, mode=mode,
                          eval_slots=eval_slots)
            out = ssw.sweep_expm_magnus2(*args, **kwargs)
            plain = ssw.sweep_expm_magnus2_plain(ssw.prepare_inputs(*args, **kwargs))
            torch.cuda.synchronize()
            pairs = [(out, plain[0])] if eval_slots is None else [(out[0], plain[0]),
                                                                  (out[1], plain[1])]
            for got, want in pairs:
                diff = float((got - want).abs().max())
                check(diff <= B2_TOL, f"B2 n={n} {mode}: kernel vs plain {diff:.2e} > {B2_TOL}")
                bitwise = bitwise and bool(torch.equal(got, want))
                worst = max(worst, diff)
            log(f"  B2 n={n:2d} {mode:11s} {'traj' if eval_slots else '    '} diff {diff:.2e}")
            if mode == "matrix_herm":
                _, text = b2_launch(ssw, ssw.prepare_inputs(*args, **kwargs))
                launches.append(f"n={n}: {text}")
    return worst, bitwise, launches


# --------------------------------------------------------------------------
# phase 6: the CR sweep gradient through the fixed-step kernel
# --------------------------------------------------------------------------
def cr_reference(torch, solver, signals_fn, amps, y0, n_steps, dt):
    """Final states (B, dim) and the loss gradient of ``amps`` (complex128
    eager engine, autograd) for a few members: the same Magnus-2 polynomial
    as the kernel, in float64. The loss is the main path's
    ``mean(|y[:, 1]|^2)`` over the full sweep, so each member contributes
    ``|y_b[1]|^2 / GRAD_SWEEP``."""
    from qiskit_dynamics_tpu_torch.ops.magnus_rule import MAGNUS_NODES
    from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla
    from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _extract_generator_data

    _, dim, static, ops, omega, _, _ = _extract_generator_data(solver.model, (0.0, 1.0), "ref")
    gauss_t = torch.as_tensor(
        dt * (np.arange(n_steps)[:, None] + MAGNUS_NODES[2][None, :]),
        device=amps.device,
    )
    amps = amps.detach().clone().requires_grad_(True)
    coef = torch.movedim(
        torch.func.vmap(lambda a: solver._rwa_signal_map(signals_fn(a))(gauss_t))(amps), 0, -1
    )
    y0_fb = solver.model.rotating_frame.state_into_frame_basis(y0)
    yf = sweep_expm_magnus2_xla(
        static, ops, omega, coef, y0_fb[:, None].expand(dim, amps.shape[0]), dt=dt,
        hermitian=True,
    )
    yf = solver.model.rotating_frame.state_out_of_frame_basis(yf).T
    loss = torch.sum(yf[:, 1].abs() ** 2) / GRAD_SWEEP
    (grad,) = torch.autograd.grad(loss, amps)
    return yf.detach(), grad


def phase_grad(torch, ssw, Signal, cr_solver):
    cuda = torch.device("cuda")
    solver, w1 = cr_solver(device=cuda)
    dim = solver.model.dim
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0
    amps = torch.linspace(0.25, 1.0, GRAD_SWEEP, dtype=torch.float64, device=cuda)

    def signals_fn(amp):
        return [Signal(lambda t: amp * AMP_SCALE, carrier_freq=w1)]

    kw = dict(t_span=(0.0, T_MAIN), y0=y0, method="fused_magnus2", max_dt=GRAD_MAX_DT)

    def forward():
        with torch.no_grad():
            return solver.solve_sweep(signals_fn, amps, **kw)

    def value_and_grad():
        a = amps.clone().requires_grad_(True)
        yf = solver.solve_sweep(signals_fn, a, **kw)
        loss = torch.mean(yf[:, 1].abs() ** 2)
        (g,) = torch.autograd.grad(loss, a)
        return yf.detach(), g

    value_and_grad()  # warm-up
    torch.cuda.synchronize()
    before = launched("sweep_magnus2_launch")
    with Capture(ssw) as cap:
        yf, g = value_and_grad()
        torch.cuda.synchronize()
    launches = launched("sweep_magnus2_launch") - before
    check(launches > 0, "the gradient path did not launch the sweep_magnus2 kernel")
    check(yf.shape == (GRAD_SWEEP, dim) and g.shape == (GRAD_SWEEP,), "gradient path shapes")
    check(bool(torch.isfinite(yf).all()) and bool(torch.isfinite(g).all()),
          "non-finite values on the gradient path")
    (inputs,) = cap.last

    probes = torch.as_tensor([0, GRAD_SWEEP // 2, GRAD_SWEEP - 1], device=cuda)
    n_steps = inputs.steps
    ref_y, ref_g = cr_reference(torch, solver, signals_fn, amps[probes], torch.as_tensor(
        y0, device=cuda), n_steps, T_MAIN / n_steps)
    fwd_err = float((yf[probes] - ref_y).abs().max())
    grad_err = float((g[probes] - ref_g).abs().max() / ref_g.abs().max())
    check(fwd_err <= FWD_TOL, f"gradient path forward vs complex128 engine {fwd_err:.2e} > {FWD_TOL}")
    check(grad_err <= GRAD_TOL, f"gradient vs complex128 autograd {grad_err:.2e} > {GRAD_TOL} of max |g|")

    ref_solver, _ = cr_solver(device="cpu")  # float64 on the host
    pop_err = 0.0
    for a, got in zip(amps[probes].tolist(), yf[probes].cpu().numpy()):
        res = ref_solver.solve(
            t_span=[0.0, T_MAIN], y0=y0, method="DOP853", atol=1e-8, rtol=1e-8,
            signals=[Signal(lambda t, a=a: a * AMP_SCALE, carrier_freq=w1)],
        )
        pop_err = max(pop_err, float(np.max(np.abs(np.abs(res.y[-1]) ** 2 - np.abs(got) ** 2))))

    fwd_call, fwd_block, fwd_reps = steady_time(torch, forward)
    grad_call, grad_block, grad_reps = steady_time(torch, value_and_grad)
    kernel_ms = cuda_ms(torch, lambda: ssw._launch_kernel(inputs), reps=5)
    kernel_out = ssw._launch_kernel(inputs)[0]
    plain_ms, plain = timed_ms(torch, lambda: ssw.sweep_expm_magnus2_plain(inputs))
    plain_out = plain[0]
    diff = float((kernel_out - plain_out).abs().max())
    check(diff <= B2_TOL, f"gradient-path kernel vs plain {diff:.2e} > {B2_TOL}")
    eager_ms = eager_engine_ms(torch, inputs)
    bound_ms, bound_by = b2_bound(inputs)
    _, launch_text = b2_launch(ssw, inputs)
    print(
        f"phase 6 CR gradient: n={dim}, {GRAD_SWEEP} members, {n_steps} steps (T={T_MAIN}, "
        f"max_dt={GRAD_MAX_DT}), mode {inputs.mode}, {inputs.batch} lanes: forward "
        f"{GRAD_SWEEP / fwd_call:.1f} sims/s ({fwd_reps} calls in {fwd_block:.2f} s), "
        f"{GRAD_SWEEP / grad_call:.1f} grad-sims/s ({grad_reps} calls in {grad_block:.2f} s, "
        f"{grad_call * 1e3:.1f} ms/call); kernel {kernel_ms:.3f} ms (bound {bound_ms:.3f} ms, "
        f"{bound_by}), plain {plain_ms:.1f} ms, eager engine {eager_ms:.2f} ms; kernel vs plain "
        f"{diff:.2e}{' (bitwise)' if diff == 0.0 else ''}; probes vs complex128 engine: "
        f"states {fwd_err:.2e} (<= {FWD_TOL}), gradient {grad_err:.2e} of max |g| "
        f"(<= {GRAD_TOL}); population error vs DOP853(1e-8), not gated: {pop_err:.2e}; "
        f"launches {launches}; launch: {launch_text}",
        flush=True,
    )
    return dict(launches=launches, max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, eager_ms=eager_ms,
                grad_sims_per_s=GRAD_SWEEP / grad_call, sims_per_s=GRAD_SWEEP / fwd_call)


def eager_engine_ms(torch, inputs):
    """Milliseconds of the eager engine (the port of the JAX package's
    sweep_engine="xla") on the kernel's inputs, CUDA events over 3 calls."""
    from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla

    static = torch.complex(inputs.statr, inputs.stati)
    ops = torch.complex(inputs.opsr, inputs.opsi)
    y0 = torch.complex(inputs.y0r, inputs.y0i)

    def run():
        with torch.no_grad():
            sweep_expm_magnus2_xla(static, ops, inputs.omega, inputs.coef, y0, dt=inputs.dt,
                                   t0=inputs.t0, order=inputs.order,
                                   hermitian=inputs.mode == "matrix_herm")

    return cuda_ms(torch, run, reps=3)


# --------------------------------------------------------------------------
# phase 7: the Lindblad density-matrix sweep (BASELINE config 3)
# --------------------------------------------------------------------------
def lindblad_solver(Solver, device):
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    sm = np.array([[0, 1], [0, 0]], dtype=complex)
    H0 = 2 * np.pi * 5.0 * Z / 2
    return Solver(
        static_hamiltonian=H0, hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
        static_dissipators=[np.sqrt(0.02) * sm], rotating_frame=np.diag(H0), vectorized=True,
        device=device,
    )


def phase_lindblad(torch, ssw, Signal, Solver):
    cuda = torch.device("cuda")
    solver = lindblad_solver(Solver, cuda)
    rho0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)
    amps = torch.linspace(0.2, 1.0, LIND_SWEEP, dtype=torch.float64, device=cuda)

    def signals_fn(amp):
        return ([Signal(lambda t: amp, carrier_freq=5.0)], None)

    def sweep():
        return solver.solve_sweep(signals_fn, amps, t_span=(0.0, LIND_T), y0=rho0,
                                  method="fused_magnus2", max_dt=LIND_MAX_DT)

    sweep()
    torch.cuda.synchronize()
    before = launched("sweep_magnus2_launch")
    with Capture(ssw) as cap:
        out = sweep()
        torch.cuda.synchronize()
    launches = launched("sweep_magnus2_launch") - before
    check(launches > 0, "the Lindblad path did not launch the sweep_magnus2 kernel")
    check(out.shape == (LIND_SWEEP, 2, 2), f"Lindblad output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite Lindblad density matrices")
    (inputs,) = cap.last
    trace_dev = float((out[:, 0, 0] + out[:, 1, 1] - 1.0).abs().max())

    host = lindblad_solver(Solver, "cpu")
    probes = [0, LIND_SWEEP // 2, LIND_SWEEP - 1]
    start = time.perf_counter()
    err = 0.0
    for i in probes:
        a = float(amps[i])
        res = host.solve(t_span=[0.0, LIND_T], y0=rho0, method="DOP853", atol=1e-10,
                         rtol=1e-10, signals=[Signal(a, carrier_freq=5.0)])
        err = max(err, float(np.max(np.abs(res.y[-1] - out[i].cpu().numpy()))))
    dop853_s = (time.perf_counter() - start) / len(probes)
    check(err <= LIND_TOL, f"Lindblad max error {err:.2e} > {LIND_TOL} against DOP853(1e-10)")

    per_call, block_s, reps = steady_time(torch, sweep)
    kernel_ms = cuda_ms(torch, lambda: ssw._launch_kernel(inputs), reps=5)
    kernel_out = ssw._launch_kernel(inputs)[0]
    plain_ms, plain = timed_ms(torch, lambda: ssw.sweep_expm_magnus2_plain(inputs))
    plain_out = plain[0]
    diff = float((kernel_out - plain_out).abs().max())
    check(diff <= B2_TOL, f"Lindblad kernel vs plain {diff:.2e} > {B2_TOL}")
    eager_ms = eager_engine_ms(torch, inputs)
    bound_ms, bound_by = b2_bound(inputs)
    _, launch_text = b2_launch(ssw, inputs)
    print(
        f"phase 7 Lindblad config 3: solve_dim 4, {LIND_SWEEP} members, {inputs.steps} steps "
        f"(T={LIND_T}, max_dt={LIND_MAX_DT}), mode {inputs.mode}: {LIND_SWEEP / per_call:.1f} "
        f"sims/s ({reps} calls in {block_s:.2f} s, {per_call * 1e3:.2f} ms/call); kernel "
        f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}), plain {plain_ms:.1f} ms, "
        f"eager engine {eager_ms:.2f} ms; kernel vs plain {diff:.2e}"
        f"{' (bitwise)' if diff == 0.0 else ''}; max error {err:.2e} (<= {LIND_TOL}, "
        f"{len(probes)} probes vs DOP853 1e-10 at {dop853_s:.2f} s/sim); max |trace - 1| "
        f"{trace_dev:.2e}; launches {launches}; launch: {launch_text}",
        flush=True,
    )
    return dict(launches=launches, max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, eager_ms=eager_ms,
                sims_per_s=LIND_SWEEP / per_call)


# --------------------------------------------------------------------------
# phase 8: the member-sweep and Horner kernels against their plain versions
# --------------------------------------------------------------------------
def member_problem(torch, n, members, steps, magnus, hermitian, k=2, scale=1.5):
    """Seeded member-sweep inputs on the card: norm-1 states, generators of
    norm ~2 ``scale`` (at 1.5 a step of 0.05 moves the state by ~0.15), a
    diagonal frame."""
    gen = np.random.default_rng(1000 * magnus + n)
    a = gen.normal(size=(k + 1, n, n)) + 1j * gen.normal(size=(k + 1, n, n))
    if hermitian:
        a = -1j * (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
    a = a * (scale / np.sqrt(n))
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, magnus, k, members)), device="cuda").float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device="cuda")
    return a[0], a[1:], w[None, :] - w[:, None], coef, y0


def horner_problem(torch, n, members):
    """Seeded Horner inputs on the card: transposed planes of norm ~1, norm-1 states."""
    gen = np.random.default_rng(n)
    scale = 0.7 / np.sqrt(n)
    planes = [torch.as_tensor(scale * gen.normal(size=(members, n, n)), device="cuda").float()
              for _ in range(2)]
    v = gen.normal(size=(2, members, n))
    v = v / np.sqrt((v**2).sum(axis=(0, 2), keepdims=True))
    return planes + [torch.as_tensor(x, device="cuda").float() for x in v]


def b3_bracket_diffs(torch, msw):
    """B3 at :data:`B3_BRACKET_CASES`, ``hermitian`` off and on, against the
    plain version in complex128: a list of ((magnus, n, hermitian), diff)."""
    out = []
    for magnus, n in B3_BRACKET_CASES:
        for hermitian in (False, True):
            static, ops, omega, coef, y0 = member_problem(torch, n, 37, 5, magnus, True,
                                                          scale=10.0)
            kwargs = dict(dt=0.1, t0=0.2, hermitian=hermitian, magnus=magnus)
            kernel = msw.sweep_expm_magnus2_member(static, ops, omega, coef, y0, **kwargs)
            exact = msw.sweep_expm_magnus2_member_plain(
                msw.prepare_inputs(static, ops, omega, coef.double(), y0, **kwargs))
            torch.cuda.synchronize()
            out.append(((magnus, n, hermitian), float((kernel - exact).abs().max())))
    return out


def phase_large_dim_kernels(torch, msw, hp):
    """Both kernels against their plain versions, and B3's bracket-dominated
    cases against complex128. Returns the three max diffs."""
    members = 37  # a ragged batch
    worst_member = 0.0
    for magnus, dims in ((2, B3_DIMS2), (3, B3_DIMS3)):
        for n in dims:
            for hermitian in (False, True):
                args = member_problem(torch, n, members, 5, magnus, hermitian)
                kwargs = dict(dt=0.05, t0=0.2, hermitian=hermitian, magnus=magnus)
                out = msw.sweep_expm_magnus2_member(*args, **kwargs)
                plain = msw.sweep_expm_magnus2_member_plain(msw.prepare_inputs(*args, **kwargs))
                torch.cuda.synchronize()
                check(out.shape == (n, members), f"B3 n={n}: output shape {tuple(out.shape)}")
                diff = float((out - plain).abs().max())
                check(diff <= B3_TOL, f"B3 magnus={magnus} n={n} hermitian={hermitian}: kernel "
                      f"vs plain {diff:.2e} > {B3_TOL}")
                worst_member = max(worst_member, diff)
                log(f"  B3 magnus {magnus} n={n:3d} hermitian {hermitian!s:5s} diff {diff:.2e}")
    worst_bracket = 0.0
    for (magnus, n, hermitian), diff in b3_bracket_diffs(torch, msw):
        check(diff <= B3_BRACKET_TOL, f"B3 bracket-dominated magnus={magnus} n={n} hermitian="
              f"{hermitian}: kernel vs complex128 {diff:.2e} > {B3_BRACKET_TOL}")
        worst_bracket = max(worst_bracket, diff)
        log(f"  B3 bracket-dominated magnus {magnus} n={n:3d} hermitian {hermitian!s:5s} "
            f"vs complex128 {diff:.2e}")
    worst_horner = 0.0
    for n, order, batch, force_stream in B4_CASES:
        planes = horner_problem(torch, n, batch)
        if force_stream:
            ur, ui = hp._launch_kernel(*planes, order, force_stream=True)
        else:
            ur, ui = hp.horner_apply_bm(*planes, order=order)
        plain_r, plain_i = hp.horner_twin_bm(*planes, order=order)
        torch.cuda.synchronize()
        diff = float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max()))
        check(diff <= B3_TOL, f"B4 n={n} order={order} members={batch}: kernel vs plain "
              f"{diff:.2e} > {B3_TOL}")
        worst_horner = max(worst_horner, diff)
        log(f"  B4 n={n:4d} order {order:2d} members {batch:3d} "
            f"{'streaming forced' if force_stream else ''} diff {diff:.2e}")
        del planes, ur, ui, plain_r, plain_i
    return worst_member, worst_horner, worst_bracket


# --------------------------------------------------------------------------
# phase 9: the Lindblad dim-8 sweep through the member-sweep kernel
# --------------------------------------------------------------------------
def b3_bounds(inputs):
    """Both bounds of one member-sweep launch, from
    :mod:`portbench.counts.magnus_member` (which says what it counts):
    ``f32_ms`` counts everything at the FP32 rate outside the tensor cores;
    ``tf32x3_ms``, the bound the kernel's design is held to, counts the
    products as three TF32 passes on the tensor cores (3xTF32, 495 TFLOP/s
    dense) and the rest at the FP32 rate. ``products_*_ms`` are the
    products' share of each."""
    shape = dict(n=inputs.n, k=inputs.k, order=inputs.order, steps=inputs.steps,
                 members=inputs.batch, magnus_order=inputs.magnus, hermitian=inputs.hermitian)
    product_flops, other_flops, nbytes = magnus_member.counts(shape)
    f32_ms, f32_by = bound(product_flops + other_flops, nbytes)
    tf32_s, tf32_by = magnus_member.tf32x3(shape)
    return dict(f32_ms=f32_ms, f32_by=f32_by, tf32x3_ms=tf32_s * 1e3, tf32x3_by=tf32_by,
                products_f32_ms=product_flops / PEAK_F32 * 1e3,
                products_tf32x3_ms=3 * product_flops / PEAK_TF32 * 1e3)


def b3_bound(inputs):
    """(bound_ms, bound_by) that B3 is held to: :func:`b3_bounds`' 3xTF32 bound."""
    bounds = b3_bounds(inputs)
    return bounds["tf32x3_ms"], bounds["tf32x3_by"]


def b3_blocks_per_sm(lib, inputs):
    """Blocks of the member-sweep kernel that one SM holds at these inputs
    (the CUDA occupancy calculator, through the kernel library)."""
    return lib.member_sweep_blocks_per_sm(inputs.n, inputs.k)


def host_references(Signal, solver, rho0, carrier, amps, t_final):
    """DOP853 (atol = rtol = 1e-12, float64 on the host) final density
    matrices for ``amps``, and the seconds per member."""
    start = time.perf_counter()
    refs = [
        solver.solve(t_span=[0.0, t_final], y0=rho0, method="DOP853", atol=1e-12, rtol=1e-12,
                     signals=[Signal(float(a), carrier_freq=carrier)]).y[-1]
        for a in amps
    ]
    return refs, (time.perf_counter() - start) / len(amps)


def phase_lindblad8(torch, msw, Signal, solver, rho0, carrier, refs, ref_s, magnus, max_dt,
                    limit):
    from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla

    amps = torch.linspace(0.2, 1.0, L8_SWEEP, dtype=torch.float64, device="cuda")
    dim = rho0.shape[0]

    def signals_fn(amp):
        return ([Signal(lambda t: amp, carrier_freq=carrier)], None)

    def sweep():  # sweep_engine is left at "auto"
        return solver.solve_sweep(signals_fn, amps, t_span=(0.0, L8_T), y0=rho0,
                                  method="fused_magnus2", max_dt=max_dt, magnus_order=magnus)

    sweep()
    torch.cuda.synchronize()
    before = launched("member_sweep_launch")
    with Capture(msw) as cap:
        out = sweep()
        torch.cuda.synchronize()
    launches = launched("member_sweep_launch") - before
    check(launches > 0, f"the dim-8 Magnus-{magnus} path did not launch the member_sweep kernel")
    check(out.shape == (L8_SWEEP, dim, dim), f"dim-8 output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite dim-8 density matrices")
    (inputs,) = cap.last
    trace_dev = float((torch.diagonal(out, dim1=1, dim2=2).sum(-1) - 1.0).abs().max())
    probes = [0, L8_SWEEP // 2, L8_SWEEP - 1]
    err = max(float(np.max(np.abs(ref - out[i].cpu().numpy()))) for i, ref in zip(probes, refs))
    check(err <= limit, f"dim-8 Magnus-{magnus} max error {err:.2e} > {limit} against "
          f"DOP853(1e-12)")

    per_call, block_s, reps = steady_time(torch, sweep)
    kernel_ms = cuda_ms(torch, lambda: msw._launch_kernel(inputs), reps=2)
    kernel_out = msw._launch_kernel(inputs)
    plain_ms, plain_out = timed_ms(torch, lambda: msw.sweep_expm_magnus2_member_plain(inputs))
    diff = float((kernel_out - plain_out).abs().max())
    check(diff <= B3_TOL, f"dim-8 Magnus-{magnus} kernel vs plain {diff:.2e} > {B3_TOL}")
    del plain_out

    def eager():
        with torch.no_grad():
            return sweep_expm_magnus2_xla(
                inputs.static, inputs.ops, inputs.omega, inputs.coef, inputs.y0, dt=inputs.dt,
                t0=inputs.t0, order=inputs.order, hermitian=inputs.hermitian,
                magnus_order=magnus)

    eager_ms, _ = timed_ms(torch, eager)
    bound_ms, bound_by = b3_bound(inputs)
    bounds = b3_bounds(inputs)
    # the part split, from the kernel's own arguments: order 1 (Horner's share)
    # and, at Magnus-2, hermitian (one product instead of two) on the same inputs
    order1_ms = cuda_ms(torch, lambda: msw._launch_kernel(dataclasses.replace(inputs, order=1)),
                        reps=1)
    herm = {}
    if magnus == 2:
        herm["hermitian_ms"] = cuda_ms(torch, lambda: msw._launch_kernel(
            dataclasses.replace(inputs, hermitian=True)), reps=1)
    blocks = b3_blocks_per_sm(msw._LIB, inputs)
    print(
        f"phase 9 Lindblad dim 8, Magnus-{magnus}: solve_dim {inputs.n}, {L8_SWEEP} members, "
        f"{inputs.steps} steps (T={L8_T}, max_dt={max_dt}), sweep_engine auto -> member: "
        f"{L8_SWEEP / per_call:.1f} sims/s ({reps} calls in {block_s:.2f} s, "
        f"{per_call * 1e3:.1f} ms/call); kernel {kernel_ms:.1f} ms (bound {bound_ms:.1f} ms "
        f"with the products in 3xTF32, {bound_ms / kernel_ms:.0%}; {bounds['f32_ms']:.1f} ms "
        f"at the FP32 rate, {bounds['f32_ms'] / kernel_ms:.0%}; {bound_by}), plain "
        f"{plain_ms:.1f} ms, eager engine {eager_ms:.1f} ms (one call each, full shape); "
        f"kernel at Horner order 1 {order1_ms:.1f} ms"
        + (f", with hermitian {herm['hermitian_ms']:.1f} ms" if herm else "") + "; "
        f"{blocks} blocks of 8 warps per SM; kernel vs plain {diff:.2e} (<= {B3_TOL}); max "
        f"error {err:.2e} (<= {limit}, {len(probes)} probes vs DOP853 1e-12 at {ref_s:.2f} "
        f"s/sim); max |trace - 1| {trace_dev:.2e}; launches {launches}",
        flush=True,
    )
    return dict(launches=launches, max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_fp32_ms=bounds["f32_ms"],
                order1_ms=order1_ms, **herm, blocks_per_sm=blocks,
                eager_ms=eager_ms, sims_per_s=L8_SWEEP / per_call, max_err=err)


# --------------------------------------------------------------------------
# phase 10: the Lindblad dim-256 sweep through the polynomial engine
# --------------------------------------------------------------------------
def phase_lindblad256(torch, hp, Signal, lindblad_two_transmon_solver):
    solver, rho0, carrier = lindblad_two_transmon_solver(device="cuda")
    amps = torch.linspace(0.2, 1.0, L256_SWEEP, dtype=torch.float64, device="cuda")
    dim = rho0.shape[0]

    def signals_fn(amp):
        return ([Signal(lambda t: amp, carrier_freq=carrier)], None)

    def sweep(**engine):
        return solver.solve_sweep(signals_fn, amps, t_span=(0.0, L256_T), y0=rho0,
                                  method="fused_magnus2", max_dt=L256_MAX_DT, magnus_order=3,
                                  **engine)

    def poly():  # poly_horner is left at "auto"
        return sweep(sweep_engine="poly")

    poly()
    torch.cuda.synchronize()
    before = launched("horner_apply_launch")
    with Capture(hp) as cap:
        out = poly()
        torch.cuda.synchronize()
    launches = launched("horner_apply_launch") - before
    steps = math.ceil(L256_T / L256_MAX_DT)
    check(launches == steps, f"the dim-256 path launched the horner_apply kernel {launches} "
          f"times, not once per step ({steps})")
    check(out.shape == (L256_SWEEP, dim, dim), f"dim-256 output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite dim-256 density matrices")
    trace_dev = float((torch.diagonal(out, dim1=1, dim2=2).sum(-1) - 1.0).abs().max())

    host, _, _ = lindblad_two_transmon_solver(device="cpu")
    probes = [0, L256_SWEEP - 1]
    refs, ref_s = host_references(Signal, host, rho0, carrier, amps[probes].tolist(), L256_T)
    err = max(float(np.max(np.abs(ref - out[i].cpu().numpy()))) for i, ref in zip(probes, refs))
    check(err <= L256_TOL, f"dim-256 max error {err:.2e} > {L256_TOL} against DOP853(1e-12)")

    per_call, block_s, reps = steady_time(torch, poly)
    MTr, MTi, vr, vi, order = cap.last
    n = vr.shape[1]
    kernel_ms = cuda_ms(torch, lambda: hp._launch_kernel(MTr, MTi, vr, vi, order), reps=5)
    # the part split from the kernel's own arguments: at order 1 a member is
    # its load, one exchange round (the state) and one mat-vec, not a chain
    order1_ms = cuda_ms(torch, lambda: hp._launch_kernel(MTr, MTi, vr, vi, 1), reps=5)
    stream_ms = cuda_ms(
        torch, lambda: hp._launch_kernel(MTr, MTi, vr, vi, order, force_stream=True), reps=5)
    lib = hp._LIB
    cluster = lib.horner_apply_cluster(n)
    clusters = lib.horner_apply_active_clusters(n, cluster)
    ptxas = Path(lib.path + ".ptxas.txt")
    resources = " | ".join(
        line.split(":", 1)[-1].strip() for line in
        (ptxas.read_text().splitlines() if ptxas.exists() else [])
        if "registers" in line or "spill" in line)
    ur, ui = hp._launch_kernel(MTr, MTi, vr, vi, order)
    hp.horner_twin_bm(MTr, MTi, vr, vi, order=order)  # warm-up
    plain_ms, (plain_r, plain_i) = timed_ms(
        torch, lambda: hp.horner_twin_bm(MTr, MTi, vr, vi, order=order))
    diff = float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max()))
    check(diff <= B3_TOL, f"dim-256 horner kernel vs plain {diff:.2e} > {B3_TOL}")
    del MTr, MTi, plain_r, plain_i, cap
    flops = order * 8 * n * n * L256_SWEEP
    nbytes = 4 * (2 * L256_SWEEP * n * n + 4 * L256_SWEEP * n)
    bound_ms, bound_by = bound(flops, nbytes)
    ops_ms = flops / PEAK_F32 * 1e3

    einsum_ms, out_e = timed_ms(torch, lambda: sweep(sweep_engine="poly", poly_horner="einsum"))
    route_diff = float((out_e - out).abs().max())
    check(route_diff <= 1e-5, f"dim-256 kernel route vs einsum route {route_diff:.2e} > 1e-5")
    xla_ms, out_x = timed_ms(torch, lambda: sweep(sweep_engine="xla"))
    err_x = max(float(np.max(np.abs(ref - out_x[i].cpu().numpy())))
                for i, ref in zip(probes, refs))
    print(
        f"phase 10 Lindblad dim 256: solve_dim {n}, {L256_SWEEP} members, {steps} steps "
        f"(T={L256_T}, max_dt={L256_MAX_DT}), Magnus-3, sweep_engine poly, poly_horner auto -> "
        f"kernel: {L256_SWEEP / per_call:.1f} sims/s ({reps} calls in {block_s:.2f} s, "
        f"{per_call * 1e3:.1f} ms/call); horner kernel {kernel_ms:.3f} ms per launch at order "
        f"{order}, {order1_ms:.3f} ms at order 1 (bound {bound_ms:.3f} ms, {bound_by}, "
        f"{bound_ms / kernel_ms:.0%}; the operations alone {ops_ms:.3f} ms at the FP32 rate, "
        f"{ops_ms / kernel_ms:.0%}; clusters of {cluster} blocks, {clusters} co-resident; "
        f"ptxas {resources}; its streaming variant, not on this path, "
        f"{stream_ms:.3f} ms), plain {plain_ms:.3f} ms; kernel vs plain {diff:.2e} "
        f"(<= {B3_TOL}); einsum route {einsum_ms:.1f} ms/call "
        f"({L256_SWEEP / einsum_ms * 1e3:.1f} sims/s, one call, vs kernel route {route_diff:.2e}); "
        f"eager engine {xla_ms:.1f} ms/call ({L256_SWEEP / xla_ms * 1e3:.1f} sims/s, one call, "
        f"max error {err_x:.2e}); max error {err:.2e} (<= {L256_TOL}, {len(probes)} probes vs "
        f"DOP853 1e-12 at {ref_s:.2f} s/sim); max |trace - 1| {trace_dev:.2e}; launches "
        f"{launches}",
        flush=True,
    )
    return dict(launches=launches, max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, sims_per_s=L256_SWEEP / per_call,
                einsum_call_ms=einsum_ms, eager_call_ms=xla_ms, max_err=err,
                streaming_ms=stream_ms, order1_ms=order1_ms, clusters_resident=clusters,
                bound_ops_ms=ops_ms)


# --------------------------------------------------------------------------
# phase 11: the perturbative kernels against their plain versions
# --------------------------------------------------------------------------
def unitary_stack(gen, T, n, B, dtype=np.complex64):
    """(T, n, n, B) near-unitary propagators: exp(-i H) to second order for
    small Hermitian H, so a chain of them keeps the state's norm."""
    h = gen.normal(size=(T, B, n, n)) + 1j * gen.normal(size=(T, B, n, n))
    h = 0.3 / np.sqrt(n) * (h + np.conj(np.swapaxes(h, -1, -2))) / 2
    u = np.eye(n) - 1j * h - h @ h / 2
    return np.ascontiguousarray(np.transpose(u, (0, 2, 3, 1))).astype(dtype)


# the instantiation a batched_linalg launch takes, by kind, lane kernel and
# dtype, as a fragment of its mangled name in the ptxas report
BL_PTXAS_TAGS = {
    ("expm", True, False): "16expm_lane_kernelILi{np}EfE",
    ("expm", True, True): "16expm_lane_kernelILi{np}EdE",
    ("expm_bwd", True, False): "20expm_bwd_lane_kernelILi{np}EE",
    ("expm", False, False): "15expm_bol_kernelILi{tile}ELb{wide}EfE",
    ("expm", False, True): "15expm_bol_kernelILi{tile}ELb{wide}EdE",
    ("expm_bwd", False, False): "19expm_bwd_bol_kernelILi{tile}ELb{wide}EE",
    ("matmul", False, False): "17matmul_bol_kernelILi{tile}ELb{wide}EE",
}


def bl_launch(bl, which, n, lanes, double=False):
    """(shape, text): the launch a batched_linalg kernel takes on ``lanes``
    lanes of n x n matrices, and a line of its shape, the warps it keeps
    resident per SM and the registers and spills ptxas reported for that
    instantiation in the library this run loaded."""
    shape = bl.launch_shape(which, n, lanes, double=double)
    report = Path(bl._LIB.path + ".ptxas.txt")
    tag = BL_PTXAS_TAGS[(which, shape.lane_kernel, double)].format(
        np=n + n % 2, tile=5 if n % 5 == 0 else 4, wide=int(shape.wide))
    ptxas = ptxas_entry(report.read_text() if report.exists() else "", tag)
    kind = "lane kernel" if shape.lane_kernel else ("wide" if shape.wide else "tiled")
    return shape, (
        f"{kind}, {shape.lanes_per_block} lanes per block x {shape.threads_per_lane} threads per "
        f"lane, {shape.threads} threads, {shape.blocks} blocks, {shape.smem_bytes} B shared, "
        f"{shape.blocks_per_sm} blocks = {shape.warps_per_sm} warps per SM, ptxas: {ptxas}")


def block_expm_vjp(torch, bl, planes):
    """The one PyTorch call that computes B7's function: the upper right
    block of ``matrix_exp([[X^H, G], [0, X^H]])`` over the lanes, the
    Frechet derivative of exp at X^H in the direction G (B7 computes that of
    the Taylor recursion). The block matrices are made here, outside any
    timing of the call returned."""
    n = planes[0].shape[0]
    xh = bl.from_bol(planes[0], -planes[1]).transpose(1, 2)
    block = torch.zeros((xh.shape[0], 2 * n, 2 * n), dtype=xh.dtype, device=xh.device)
    block[:, :n, :n] = block[:, n:, n:] = xh
    block[:, :n, n:] = bl.from_bol(planes[2], planes[3])
    del xh
    return lambda: torch.linalg.matrix_exp(block)[:, :n, n:]


def unit_planes(torch, gen, n, B, count=2, dtype=None, device="cuda"):
    """``count`` (n, n, B) planes on ``device``, float32 unless ``dtype``
    says otherwise; each lane's complex matrix has Frobenius norm 1."""
    x = gen.normal(size=(count // 2, 2, n, n, B))
    x = x / np.sqrt((x**2).sum(axis=(1, 2, 3), keepdims=True))
    return [torch.as_tensor(p, device=device).to(dtype or torch.float32)
            for p in x.reshape(count, n, n, B)]


def planes_diff(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def phase_perturbative_kernels(torch, ca, bl):
    """B5, B10, B6, B7 against their plain versions, each launch counted.
    Returns the four max diffs."""
    worst = dict(chain=0.0, matmul=0.0, expm=0.0, expm_bwd=0.0)

    def launches():
        return (launched("chain_apply_launch"), launched("matmul_bol_launch"),
                launched("expm_bol_launch"), launched("expm_bwd_bol_launch"))

    for n in PT_DIMS:
        for B in PT_BATCHES:
            before = launches()
            for T in (1, 7):
                gen = np.random.default_rng(100 * n + T)
                props = torch.as_tensor(unitary_stack(gen, T, n, B), device="cuda")
                y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
                y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device="cuda").to(
                    torch.complex64)
                out, plain = ca.chain_apply_bol(props, y0), ca.chain_apply_bol_plain(props, y0)
                torch.cuda.synchronize()
                check(torch.equal(out, plain), f"B5 n={n} B={B} T={T}: kernel and plain version "
                      f"differ by {float((out - plain).abs().max()):.2e}, not bit for bit")
            planes = unit_planes(torch, np.random.default_rng(n), n, B, count=4)
            diff = planes_diff(bl.matmul_bol(*planes), bl.matmul_bol_plain(*planes))
            check(diff <= PT_KERNEL_TOL, f"B10 n={n} B={B}: kernel vs plain {diff:.2e}")
            worst["matmul"] = max(worst["matmul"], diff)
            for order, squarings in PT_EXPM_CASES:
                diff = planes_diff(bl.expm_taylor_bol(*planes[:2], order, squarings),
                                   bl.expm_taylor_bol_plain(*planes[:2], order, squarings))
                check(diff <= PT_KERNEL_TOL,
                      f"B6 n={n} B={B} order={order} squarings={squarings}: kernel vs plain "
                      f"{diff:.2e} > {PT_KERNEL_TOL}")
                worst["expm"] = max(worst["expm"], diff)
                diff = planes_diff(bl.expm_taylor_bol_bwd(*planes, order, squarings),
                                   bl.expm_taylor_bol_bwd_plain(*planes, order, squarings))
                check(diff <= PT_KERNEL_TOL,
                      f"B7 n={n} B={B} order={order} squarings={squarings}: kernel vs plain "
                      f"{diff:.2e} > {PT_KERNEL_TOL}")
                worst["expm_bwd"] = max(worst["expm_bwd"], diff)
            torch.cuda.synchronize()
            rose = tuple(a - b for a, b in zip(launches(), before))
            cases = len(PT_EXPM_CASES)
            check(rose == (2, 1, cases, cases), f"n={n} B={B}: kernel launches {rose}")
            log(f"  B5/B10/B6/B7 n={n:2d} B={B:4d}: chain bitwise, matmul {worst['matmul']:.2e}, "
                f"expm {worst['expm']:.2e}, expm_bwd {worst['expm_bwd']:.2e} (running max)")
    for n in PT_LANE_DIMS:
        for B in PT_LANE_BATCHES:
            planes = unit_planes(torch, np.random.default_rng(500 + n + B), n, B, count=4)
            before = launches()
            diff = planes_diff(bl.expm_taylor_bol(*planes[:2], 12, 1),
                               bl.expm_taylor_bol_plain(*planes[:2], 12, 1))
            want = bl.expm_taylor_bol_bwd_plain(*planes, 12, 1)
            bwd = planes_diff(bl.expm_taylor_bol_bwd(*planes, 12, 1), want)
            scale = max(1.0, max(float(w.abs().max()) for w in want))
            torch.cuda.synchronize()
            rose = tuple(a - b for a, b in zip(launches(), before))
            check(rose == (0, 0, 1, 1), f"n={n} B={B}: kernel launches {rose}")
            check(diff <= PT_KERNEL_TOL and bwd <= PT_KERNEL_TOL * scale,
                  f"B6/B7 n={n} B={B}: kernel vs plain {diff:.2e}, {bwd:.2e}")
            worst["expm"] = max(worst["expm"], diff)
            worst["expm_bwd"] = max(worst["expm_bwd"], bwd)
        log(f"  B6/B7 n={n:2d} B in {PT_LANE_BATCHES}: expm {worst['expm']:.2e}, expm_bwd "
            f"{worst['expm_bwd']:.2e} (running max)")
    return worst


def synthetic_expansion_solver(torch, interop, method, n, device, seed=5):
    """A Dyson or Magnus solver of dimension ``n`` around seeded arrays in
    place of a precomputed expansion (one drive, Chebyshev order 1 with the
    imaginary part: four coefficients, six monomials), complex64."""
    gen = np.random.default_rng(seed)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    udt, _ = np.linalg.qr(gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n)))
    labels = [[0], [1], [2], [3], [0, 0], [0, 2]]
    return interop.perturbative_solver_from_arrays(
        operators=anti_hermitian(1.0)[None], frame_operator=None, dt=0.1,
        carrier_freqs=np.array([5.0]), chebyshev_orders=[1], include_imag=[True], Udt=udt,
        expansion_method=method, poly_constant=np.eye(n) if method == "dyson" else None,
        poly_coefficients=np.stack([anti_hermitian(0.05) for _ in labels]),
        poly_labels=labels, device=device, dtype=torch.complex64,
    )


def perturbative_past_64(torch, ca, bl, Signal, interop):
    """Past n = 64 on the card: at n = 65 and 100 (a lane's matrices in device
    memory above 98) the chain, product and Taylor expm, the gradients of the
    ``_ad`` forms, and the Dyson and Magnus ``solve_sweep`` of a seeded
    expansion at n = 65 run the kernels, within PAST_64_TOL of the CPU's plain
    versions. Returns the max difference."""
    cuda = torch.device("cuda")

    def launches():
        return (launched("chain_apply_launch"), launched("matmul_bol_launch"),
                launched("expm_bol_launch"), launched("expm_bwd_bol_launch"))

    diffs = {}
    for n in (65, 100):
        before = launches()
        gen = np.random.default_rng(n)
        props = unitary_stack(gen, 3, n, 5)
        y0 = (gen.normal(size=(n, 5)) + 1j * gen.normal(size=(n, 5))).astype(np.complex64)
        got = ca.chain_apply_bol(torch.as_tensor(props, device=cuda),
                                 torch.as_tensor(y0, device=cuda))
        diffs[f"chain {n}"] = float((got.cpu() - ca.chain_apply_bol_plain(
            torch.as_tensor(props), torch.as_tensor(y0))).abs().max())
        planes = unit_planes(torch, gen, n, 6, count=4, device="cpu")
        on_card = [p.to(cuda) for p in planes]
        diffs[f"matmul {n}"] = planes_diff([g.cpu() for g in bl.matmul_bol(*on_card)],
                                           bl.matmul_bol_plain(*planes))
        diffs[f"expm {n}"] = planes_diff(
            [g.cpu() for g in bl.expm_taylor_bol(*on_card[:2], 8, 1)],
            bl.expm_taylor_bol_plain(*planes[:2], 8, 1))
        grads = []
        for device in (cuda, "cpu"):
            xs = [p.to(device).requires_grad_(True) for p in planes[:2]]
            pr, pi = bl.expm_taylor_bol_ad(*xs, 8, 1)
            (pr * planes[2].to(device) + pi * planes[3].to(device)).sum().backward()
            u = torch.as_tensor(props, device=device).requires_grad_(True)
            (ca.chain_apply_bol_ad(u, torch.as_tensor(y0, device=device)).abs() ** 2
             ).sum().backward()
            grads.append([xs[0].grad, xs[1].grad, u.grad])
        diffs[f"gradients {n}"] = max(float((g.cpu() - w).abs().max()) for g, w in zip(*grads))
        torch.cuda.synchronize()
        rose = tuple(a - b for a, b in zip(launches(), before))
        check(rose == (2, 1, 2, 1), f"n={n}: kernel launches {rose}, not (2, 1, 2, 1)")

    def signals(amp):
        return [Signal(lambda t: amp * torch.ones_like(t), carrier_freq=5.0)]

    n = 65
    y0 = np.zeros(n, dtype=complex)
    y0[0] = 1.0
    amps = torch.linspace(0.2, 1.0, 7, dtype=torch.float64)
    for method in ("dyson", "magnus"):
        before = launches()
        got = synthetic_expansion_solver(torch, interop, method, n, cuda).solve_sweep(
            0.0, 4, y0, signals, amps.to(cuda))
        torch.cuda.synchronize()
        rose = tuple(a - b for a, b in zip(launches(), before))
        check(rose == (1, 0, int(method == "magnus"), 0), f"{method} at n={n}: launches {rose}")
        want = synthetic_expansion_solver(torch, interop, method, n, "cpu").solve_sweep(
            0.0, 4, y0, signals, amps)
        check(got.device.type == "cuda", f"{method} solve_sweep at n={n} left the card")
        diffs[method] = float((got.cpu() - want).abs().max())
    worst = max(diffs.values())
    check(worst <= PAST_64_TOL, f"past n = 64, the card vs the CPU: {diffs} > {PAST_64_TOL}")
    log("  past n = 64: " + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))

    # times at n = 100 over 256 lanes (matrices in device memory): each kernel
    # and its plain version on the card, ms
    n, lanes = 100, 256
    gen = np.random.default_rng(7)
    props = torch.as_tensor(unitary_stack(gen, 8, n, lanes), device=cuda)
    y0 = torch.as_tensor((gen.normal(size=(n, lanes)) + 0j).astype(np.complex64), device=cuda)
    planes = unit_planes(torch, gen, n, lanes, count=4)
    cases = {
        "chain T=8": (lambda: ca.chain_apply_bol(props, y0),
                      lambda: ca.chain_apply_bol_plain(props, y0)),
        "matmul": (lambda: bl.matmul_bol(*planes), lambda: bl.matmul_bol_plain(*planes)),
        "expm": (lambda: bl.expm_taylor_bol(*planes[:2], 12, 1),
                 lambda: bl.expm_taylor_bol_plain(*planes[:2], 12, 1)),
        "expm_bwd": (lambda: bl.expm_taylor_bol_bwd(*planes, 12, 1),
                     lambda: bl.expm_taylor_bol_bwd_plain(*planes, 12, 1)),
    }
    times = {name: (cuda_ms(torch, kernel, reps=3), cuda_ms(torch, plain, reps=3))
             for name, (kernel, plain) in cases.items()}
    # bounds and the one PyTorch call that computes each (made outside the timing)
    left, right = torch.complex(planes[0], planes[1]), torch.complex(planes[2], planes[3])
    stack = bl.from_bol(planes[0], planes[1]).contiguous()
    order, squarings = 12, 1
    library = {
        "matmul": (bound(8.0 * n**3 * lanes, 24.0 * n * n * lanes),
                   lambda: torch.einsum("ikb,kjb->ijb", left, right)),
        "expm": (bound((order - 1 + squarings) * 8.0 * n**3 * lanes, 16.0 * n * n * lanes),
                 lambda: torch.linalg.matrix_exp(stack)),
        "expm_bwd": (bound(3 * (order - 1 + squarings) * 8.0 * n**3 * lanes,
                           24.0 * n * n * lanes), block_expm_vjp(torch, bl, planes)),
    }
    for name, ((bound_ms, bound_by), call) in library.items():
        times[name] += (bound_ms, bound_by, cuda_ms(torch, call, reps=3))
    return worst, times


def df_past_32(torch, dfs, Signal, lindblad_qudit_solver, fused_sweep_solve):
    """B8 past n = 32 on the card (its one-block-per-member sweep): at n = 33
    and 46 (planes in device memory above 45), Magnus-2 and -3, and the df32
    sweep of a vectorized dim-6 Lindblad model (solve_dim 36), within
    DF_KERNEL_TOL of the CPU's plain version, one launch each. Returns the
    max difference."""
    worst = 0.0
    for n in (33, 46):
        check(dfs.kernel_for(n) == "wide", f"n={n} does not take B8's wide sweep")
        for magnus_order in (2, 3):
            args, kwargs = df_kernel_problem(torch, n, magnus_order, False, "cuda")
            before = launched(*B8)
            got = dfs.sweep_expm_magnus_df(*args, **kwargs)
            torch.cuda.synchronize()
            check(launched(*B8) == before + 1, f"B8 at n={n}: no launch")
            want = dfs.sweep_expm_magnus_df(*args[:-1], args[-1].cpu(), **kwargs)
            worst = max(worst, float((got.cpu() - want).abs().max()))

    def lindblad(device):
        solver, rho0, carrier = lindblad_qudit_solver(dim=6, device=device)

        def signals_fn(amp):
            return [Signal(amp, carrier_freq=carrier)]

        amps = torch.linspace(0.2, 1.0, 9, dtype=torch.float64, device=device)
        return fused_sweep_solve(solver.model, signals_fn, amps, (0.0, 2.0), 0.1, rho0,
                                 precision="df32")

    before = launched(*B8)
    got = lindblad("cuda")
    torch.cuda.synchronize()
    check(launched(*B8) == before + 1, "the dim-6 df32 sweep: no B8 launch")
    check(got.device.type == "cuda" and got.shape == (9, 6, 6), "the dim-6 df32 sweep")
    worst = max(worst, float((got.cpu() - lindblad("cpu")).abs().max()))
    check(worst <= DF_KERNEL_TOL, f"B8 past n = 32, the card vs the CPU: {worst:.2e}")

    # times over 256 members, 12 Magnus-3 steps with `hermitian`: the wide
    # sweep and the plain version on the card, ms
    times = {}
    for n in (36, 46):
        args, kwargs = df_kernel_problem(torch, n, 3, True, "cuda", members=256)
        kwargs["hermitian"] = True
        inputs = dfs.prepare_df_inputs(*args, **kwargs)
        times[n] = (cuda_ms(torch, lambda: dfs.sweep_expm_magnus_df(*args, **kwargs), reps=3),
                    cuda_ms(torch, lambda: dfs.sweep_expm_magnus_df_plain(inputs), reps=1))
    return worst, times


# --------------------------------------------------------------------------
# phases 12 and 13: the Dyson and Magnus rows of BASELINE config 4
# --------------------------------------------------------------------------
PT_T = PT_STEPS * PT_DT
PT_SIGMA = PT_T / 6.0


def perturbative_probes():
    return [0, PT_SWEEP // 2 - 1, PT_SWEEP - 1]


def perturbative_references(solve_ode, amps):
    """Final states of ``amps`` in the frame of G0 (host DOP853, atol = rtol =
    1e-12, on the lab-frame generator, then exp(-T G0)), and seconds per member."""
    from scipy.linalg import expm

    number = np.diag(np.arange(PT_DIM))
    G0 = -1j * (2 * np.pi * PT_NU * number + np.pi * PT_ALPHA * number @ (number - np.eye(PT_DIM)))
    a = np.diag(np.sqrt(np.arange(1, PT_DIM)), 1)
    G1 = -1j * 2 * np.pi * PT_R * (a + a.conj().T)
    y0 = np.zeros(PT_DIM, dtype=complex)
    y0[0] = 1.0
    start = time.perf_counter()
    refs = []
    for amp in amps:
        def rhs(t, y, amp=amp):
            envelope = amp * np.exp(-((t - PT_T / 2) ** 2) / (2 * PT_SIGMA**2))
            return (G0 + np.real(envelope * np.exp(1j * 2 * np.pi * PT_NU * t)) * G1) @ y

        res = solve_ode(rhs, [0.0, PT_T], y0, method="DOP853", atol=1e-12, rtol=1e-12)
        refs.append(expm(-PT_T * G0) @ np.asarray(res.y[-1]))
    return np.stack(refs), (time.perf_counter() - start) / len(amps)


def perturbative_sweep(torch, Signal, solver, nu, amps):
    """BASELINE config 4's sweep of ``solver`` over the Gaussian amplitudes
    ``amps`` from y0 = e_0: (y0, signals_fn, forward call, gradient call). The
    gradient is that of ``sum(|y[:, 1]|^2) / B`` over checkpointed chunks."""
    from torch.utils.checkpoint import checkpoint

    y0 = np.zeros(PT_DIM, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * torch.exp(-((t - PT_T / 2) ** 2) / (2 * PT_SIGMA**2)),
                       carrier_freq=nu)]

    def sweep():
        with torch.no_grad():
            return solver.solve_sweep(0.0, PT_STEPS, y0, signals_fn, amps)

    def chunk_loss(chunk):
        yf = solver.solve_sweep(0.0, PT_STEPS, y0, signals_fn, chunk)
        return torch.sum(yf[:, 1].abs() ** 2)

    def value_and_grad():
        a = amps.clone().requires_grad_(True)
        loss = sum(checkpoint(chunk_loss, chunk, use_reentrant=False)
                   for chunk in a.reshape(PT_CHUNKS, -1)) / len(amps)
        (g,) = torch.autograd.grad(loss, a)
        return g

    return y0, signals_fn, sweep, value_and_grad


def phase_perturbative_row(torch, phase, name, make_solver, Signal, ca, bl, refs, ref_s):
    """One row (Dyson or Magnus) at full width: the forward's launches and
    accuracy, the gradient, and its kernels alone at the shapes the row gave
    them. The forward's rate is the benchmark's (cells ``dyson_sweep`` and
    ``magnus_sweep``), not timed here."""
    from qiskit_dynamics_tpu_torch.ops import monomial_contract as mc

    solver, nu = make_solver(device="cuda")
    magnus = solver.model.expansion_method == "magnus"
    terms = len(solver.model.expansion_polynomial.monomial_labels)
    amps = torch.linspace(0.2, 1.0, PT_SWEEP, dtype=torch.float64, device="cuda")
    y0, signals_fn, sweep, value_and_grad = perturbative_sweep(torch, Signal, solver, nu, amps)

    entries = ("chain_apply_launch", "expm_bol_launch", "expm_bwd_bol_launch",
               "monomial_contract_launch")

    def counted(fn):
        before = [launched(e) for e in entries]
        with Capture(ca) as cap_chain, Capture(bl) as cap_linalg, Capture(mc) as cap_b11:
            out = fn()
            torch.cuda.synchronize()
        counts = [launched(e) - b for e, b in zip(entries, before)]
        return out, counts, cap_chain.last, cap_linalg.last, cap_b11.last

    sweep()  # warm-up
    torch.cuda.synchronize()
    out, fwd_counts, chain_args, expm_args, b11_args = counted(sweep)
    check(fwd_counts[0] == 1, f"the {name} sweep launched the chain_apply kernel "
          f"{fwd_counts[0]} times, not once")
    check(fwd_counts[1] == (1 if magnus else 0), f"the {name} sweep launched the expm kernel "
          f"{fwd_counts[1]} times")
    check(fwd_counts[3] == 1, f"the {name} sweep launched the monomial_contract kernel "
          f"{fwd_counts[3]} times, not once")
    check(out.shape == (PT_SWEEP, PT_DIM), f"{name} output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"non-finite {name} states")
    norm_dev = float(((out.abs() ** 2).sum(dim=1) - 1.0).abs().max())
    probes = perturbative_probes()
    got = out[probes].cpu().numpy()
    err = float(np.max(np.abs(np.abs(got) - np.abs(refs))))
    check(err <= PT_TOL, f"{name}_max_err {err:.2e} > {PT_TOL} against DOP853(1e-12)")

    # the kernels alone, at the shapes the row gave them
    props, y0_cols = chain_args
    chain_ms = cuda_ms(torch, lambda: ca._launch_kernel(props, y0_cols), reps=5)
    chain_out = ca._launch_kernel(props, y0_cols)
    chain_plain_ms, chain_plain = timed_ms(torch, lambda: ca.chain_apply_bol_plain(props, y0_cols))
    chain_diff = float((chain_out - chain_plain).abs().max())
    check(torch.equal(chain_out, chain_plain), f"{name}: chain kernel and plain version differ by "
          f"{chain_diff:.2e}, not bit for bit")
    T, n, _, B = props.shape
    chain_bound = bound(8.0 * T * n * n * B, 8.0 * T * n * n * B + 16.0 * n * B)
    result = dict(name=name, chain=dict(
        launches=fwd_counts[0], max_abs_err=chain_diff, ms=chain_ms, plain_ms=chain_plain_ms,
        bound_ms=chain_bound[0], bound_by=chain_bound[1]))
    del props, y0_cols, chain_args, chain_out, chain_plain

    # B11 at the row's shape; its plain version is the table and addmm it
    # replaced, so the plain time is the library yardstick too
    coeffs, expansion, interleaved = b11_args
    b11_ms = cuda_ms(torch, lambda: mc._launch_kernel(coeffs, expansion, interleaved), reps=5)
    b11_out = mc._launch_kernel(coeffs, expansion, interleaved)
    b11_plain_ms = cuda_ms(
        torch, lambda: mc.contract_monomials_plain(coeffs, expansion, interleaved), reps=3)
    b11_plain = mc.contract_monomials_plain(coeffs, expansion, interleaved)
    b11_diff = float((b11_out - b11_plain).abs().max() / b11_plain.abs().max())
    check(b11_diff <= B11_TOL, f"{name}: monomial_contract kernel vs plain {b11_diff:.2e} of the "
          f"largest entry > {B11_TOL}")
    b11_lanes = coeffs.shape[1]
    b11_bound = bound(((terms - coeffs.shape[0]) + 4.0 * terms * n * n) * b11_lanes,
                      4.0 * coeffs.shape[0] * b11_lanes + 8.0 * terms * n * n
                      + 8.0 * n * n * b11_lanes)
    b11_shape = mc.launch_shape(n)
    result["b11"] = dict(
        launches=fwd_counts[3], max_abs_err=b11_diff, ms=b11_ms, plain_ms=b11_plain_ms,
        bound_ms=b11_bound[0], bound_by=b11_bound[1], library_ms=b11_plain_ms,
        shape=dataclasses.asdict(b11_shape))
    b11_text = (
        f"monomial_contract kernel {b11_ms:.3f} ms over {b11_lanes} lanes (bound "
        f"{b11_bound[0]:.3f} ms, {b11_bound[1]}; TE {b11_shape.te}, {b11_shape.warps} warps, "
        f"{b11_shape.tiles} tile(s)), plain version (the table and addmm it replaced) "
        f"{b11_plain_ms:.3f} ms, kernel vs plain {b11_diff:.2e} of the largest entry; ")
    del coeffs, expansion, b11_args, b11_out, b11_plain
    expm_text = ""
    if magnus:
        which, planes, order, squarings = expm_args
        check(which == "expm" and planes[0].shape[2] == PT_STEPS * PT_SWEEP,
              f"the Magnus sweep's last batched_linalg launch was {which} over "
              f"{planes[0].shape[2]} lanes")
        lanes = planes[0].shape[2]
        expm_ms = cuda_ms(torch, lambda: bl._launch_kernel(which, planes, order, squarings),
                          reps=3)
        expm_out = bl._launch_kernel(which, planes, order, squarings)
        expm_plain_ms, expm_plain = timed_ms(
            torch, lambda: bl.expm_taylor_bol_plain(*planes, order, squarings))
        expm_diff = planes_diff(expm_out, expm_plain)
        check(expm_diff <= PT_KERNEL_TOL, f"Magnus-row expm kernel vs plain {expm_diff:.2e}")
        del expm_plain
        stack = bl.from_bol(*planes).contiguous()  # (L, n, n) complex64, made outside the timing
        torch.linalg.matrix_exp(stack[:1024])
        library_ms, library = timed_ms(torch, lambda: torch.linalg.matrix_exp(stack))
        library_diff = float((library - bl.from_bol(*expm_out)).abs().max())
        del stack, library
        expm_bound = bound((order - 1 + squarings) * 8.0 * n**3 * lanes, 16.0 * n * n * lanes)
        expm_shape, expm_shape_text = bl_launch(bl, "expm", n, lanes)
        result["expm"] = dict(
            launches=fwd_counts[1], max_abs_err=expm_diff, ms=expm_ms, plain_ms=expm_plain_ms,
            bound_ms=expm_bound[0], bound_by=expm_bound[1], library_ms=library_ms,
            shape=dataclasses.asdict(expm_shape), warps_per_sm=expm_shape.warps_per_sm)
        expm_text = (
            f"expm kernel {expm_ms:.3f} ms over {lanes} lanes (bound {expm_bound[0]:.3f} ms, "
            f"{expm_bound[1]}), plain {expm_plain_ms:.1f} ms, torch.linalg.matrix_exp "
            f"{library_ms:.1f} ms (differs from the kernel by {library_diff:.2e}), kernel vs "
            f"plain {expm_diff:.2e}, launch: {expm_shape_text}; ")

        # the batched product's entry point, driven once at this row's width:
        # consecutive step propagators composed pairwise
        steps = torch.view_as_complex(
            torch.stack(expm_out, dim=-1)).reshape(n, n, PT_STEPS // 2, 2, PT_SWEEP)
        later = steps[:, :, :, 1].reshape(n, n, -1)
        earlier = steps[:, :, :, 0].reshape(n, n, -1)
        pair_planes = [later.real, later.imag, earlier.real, earlier.imag]
        pair_planes = [p.contiguous() for p in pair_planes]
        del steps, later, earlier, expm_out
        bl.matmul_bol(*pair_planes)
        before = launched("matmul_bol_launch")
        product = bl.matmul_bol(*pair_planes)
        torch.cuda.synchronize()
        matmul_launches = launched("matmul_bol_launch") - before
        check(matmul_launches == 1, "matmul_bol did not launch its kernel")
        matmul_ms = cuda_ms(torch, lambda: bl._launch_kernel("matmul", pair_planes), reps=5)
        matmul_plain_ms, matmul_plain = timed_ms(torch, lambda: bl.matmul_bol_plain(*pair_planes))
        matmul_diff = planes_diff(product, matmul_plain)
        check(matmul_diff <= PT_KERNEL_TOL, f"full-width matmul kernel vs plain {matmul_diff:.2e}")
        del matmul_plain, product
        left = torch.complex(pair_planes[0], pair_planes[1])
        right = torch.complex(pair_planes[2], pair_planes[3])
        torch.einsum("ikb,kjb->ijb", left[:, :, :1024], right[:, :, :1024])
        einsum_ms, _ = timed_ms(torch, lambda: torch.einsum("ikb,kjb->ijb", left, right))
        pair_lanes = pair_planes[0].shape[2]
        matmul_bound = bound(8.0 * n**3 * pair_lanes, 24.0 * n * n * pair_lanes)
        result["matmul"] = dict(
            launches=matmul_launches, max_abs_err=matmul_diff, ms=matmul_ms,
            plain_ms=matmul_plain_ms, bound_ms=matmul_bound[0], bound_by=matmul_bound[1],
            library_ms=einsum_ms)
        expm_text += (
            f"matmul_bol entry point on {pair_lanes} lanes (step pairs composed): kernel "
            f"{matmul_ms:.3f} ms (bound {matmul_bound[0]:.3f} ms, {matmul_bound[1]}), plain "
            f"{matmul_plain_ms:.1f} ms, torch.einsum {einsum_ms:.1f} ms, kernel vs plain "
            f"{matmul_diff:.2e}; ")
        del pair_planes, left, right, planes, expm_args
    torch.cuda.empty_cache()

    # the gradient over 8 checkpointed chunks
    value_and_grad()  # warm-up
    torch.cuda.synchronize()
    grad, grad_counts, _, bwd_args, _ = counted(value_and_grad)
    check(grad.shape == (PT_SWEEP,) and bool(torch.isfinite(grad).all()),
          f"{name} gradient shape or values")
    check(grad_counts[0] == 2 * PT_CHUNKS, f"the {name} gradient launched the chain_apply kernel "
          f"{grad_counts[0]} times, not {2 * PT_CHUNKS} (forward and recompute per chunk)")
    check(grad_counts[3] == 2 * PT_CHUNKS, f"the {name} gradient launched the monomial_contract "
          f"kernel {grad_counts[3]} times, not {2 * PT_CHUNKS} (forward and recompute per chunk)")
    if magnus:
        check(grad_counts[2] == PT_CHUNKS, f"the Magnus gradient launched the expm backward "
              f"kernel {grad_counts[2]} times, not {PT_CHUNKS}")
    grad_call, grad_block, grad_reps = steady_time(torch, value_and_grad)

    # reference gradient: the complex128 plain route's autograd, on the host
    host_solver, _ = make_solver(device="cpu")
    host_amps = amps[probes].cpu().requires_grad_(True)
    host_out = host_solver.solve_sweep(0.0, PT_STEPS, y0, signals_fn, host_amps)
    (ref_grad,) = torch.autograd.grad(torch.sum(host_out[:, 1].abs() ** 2) / PT_SWEEP, host_amps)
    grad_err = float((grad[probes].cpu() - ref_grad).abs().max() / ref_grad.abs().max())
    check(grad_err <= GRAD_TOL, f"{name} gradient vs complex128 plain route {grad_err:.2e} > "
          f"{GRAD_TOL} of max |g|")
    state_err = float(np.max(np.abs(got - host_out.detach().numpy())))

    bwd_text = ""
    if magnus:
        which, planes, order, squarings = bwd_args
        planes = [p.detach() for p in planes]  # saved for the backward: they require grad
        lanes = planes[0].shape[2]
        check(which == "expm_bwd" and lanes == PT_STEPS * PT_SWEEP // PT_CHUNKS,
              f"the Magnus gradient's last batched_linalg launch was {which} over {lanes} lanes")
        bwd_ms = cuda_ms(torch, lambda: bl._launch_kernel(which, planes, order, squarings), reps=3)
        bwd_out = bl._launch_kernel(which, planes, order, squarings)
        bwd_plain_ms, bwd_plain = timed_ms(
            torch, lambda: bl.expm_taylor_bol_bwd_plain(*planes, order, squarings))
        bwd_diff = planes_diff(bwd_out, bwd_plain)
        scale = max(float(p.abs().max()) for p in bwd_plain)
        check(bwd_diff <= PT_KERNEL_TOL * max(scale, 1.0),
              f"Magnus-row expm backward kernel vs plain {bwd_diff:.2e} (values up to {scale:.2e})")
        bwd_bound = bound((3 * (order - 1) + 3 * squarings) * 8.0 * n**3 * lanes,
                          24.0 * n * n * lanes)
        bwd_shape, bwd_shape_text = bl_launch(bl, "expm_bwd", n, lanes)
        del bwd_plain
        library = block_expm_vjp(torch, bl, planes)  # inputs made outside the timing
        library()
        bwd_library_ms, vjp = timed_ms(torch, library)
        bwd_library_diff = float((vjp - bl.from_bol(*bwd_out)).abs().max())
        del library, vjp
        result["expm_bwd"] = dict(
            launches=grad_counts[2], max_abs_err=bwd_diff, ms=bwd_ms, plain_ms=bwd_plain_ms,
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=bwd_library_ms,
            shape=dataclasses.asdict(bwd_shape), warps_per_sm=bwd_shape.warps_per_sm)
        result["expm"]["launches"] += grad_counts[1]
        bwd_text = (
            f"expm backward kernel {bwd_ms:.3f} ms per launch over {lanes} lanes (bound "
            f"{bwd_bound[0]:.3f} ms, {bwd_bound[1]}), plain {bwd_plain_ms:.1f} ms, "
            f"matrix_exp of the block [[X^H, G], [0, X^H]] {bwd_library_ms:.1f} ms (differs "
            f"from the kernel by {bwd_library_diff:.2e}), kernel vs plain {bwd_diff:.2e}, "
            f"launch: {bwd_shape_text}; ")
        del planes, bwd_args, bwd_out
    result["chain"]["launches"] += grad_counts[0]
    result["b11"]["launches"] += grad_counts[3]
    torch.cuda.empty_cache()
    result.update(grad_sims_per_s=PT_SWEEP / grad_call, max_err=err, grad_err=grad_err)
    print(
        f"phase {phase} {name} row: dim {PT_DIM}, {PT_SWEEP} members, {PT_STEPS} steps of "
        f"{PT_DT}, {terms} monomials (the forward's rate: the benchmark's {name}_sweep); chain "
        f"kernel {chain_ms:.3f} ms (bound {chain_bound[0]:.3f} ms, {chain_bound[1]}), plain "
        f"{chain_plain_ms:.1f} ms, bitwise equal; {b11_text}{expm_text}{name}_max_err {err:.2e} "
        f"(<= {PT_TOL}, {len(probes)} probes vs DOP853 1e-12 at {ref_s:.2f} s/sim; vs the "
        f"complex128 plain route {state_err:.2e}); max |norm - 1| {norm_dev:.2e}; gradient over "
        f"{PT_CHUNKS} checkpointed chunks: {PT_SWEEP / grad_call:.1f} grad-sims/s ({grad_reps} "
        f"calls in {grad_block:.2f} s, {grad_call * 1e3:.1f} ms/call), {bwd_text}gradient vs "
        f"complex128 plain route {grad_err:.2e} of max |g| (<= {GRAD_TOL}); launches forward "
        f"[chain, expm, expm_bwd, monomial_contract] {fwd_counts}, gradient {grad_counts}",
        flush=True,
    )
    return result


# --------------------------------------------------------------------------
# phase 14: the FP64 kernels against their plain versions
# --------------------------------------------------------------------------
def df_kernel_problem(torch, n, magnus_order, uniform, device, members=DF_MEMBERS,
                      steps=DF_STEPS, t0=3.0):
    """Seeded inputs of kernel B8 at state dimension n: anti-Hermitian
    frame-basis operators (k = 2), an antisymmetric frame matrix (|omega| <
    30), Gauss-node coefficients, unit-norm states, a uniform or non-uniform
    grid from t0."""
    from qiskit_dynamics_tpu_torch.ops.df_sweep import MAGNUS_NODES

    gen = np.random.default_rng(1000 * n + 10 * magnus_order + int(uniform))

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    w = gen.uniform(0.0, 30.0, n)
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    nodes = len(MAGNUS_NODES[magnus_order])
    dt = 0.05 if uniform else 0.05 * (1.0 + 0.5 * np.sin(np.arange(steps)))
    args = (anti_hermitian(2.0), np.stack([anti_hermitian(1.0) for _ in range(2)]),
            w[None, :] - w[:, None], gen.normal(size=(steps, nodes, 2, members)),
            torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=device))
    return args, dict(dt=dt, t0=t0, magnus_order=magnus_order)


def phase_df_kernels(torch, dfs, ca, bl, device="cuda"):
    """B8 over n, Magnus order, hermitian, grid and trajectory slots, in
    launches of 16 members (the last ragged); B5 and B6 in complex128 over the
    perturbative dims. Returns the max diffs."""
    worst = dict(df=0.0, chain=0.0, expm=0.0)
    for n in DF_DIMS:
        for magnus_order in (2, 3):
            for hermitian in (False, True):
                for uniform, slots in ((True, False), (False, True)):
                    args, kwargs = df_kernel_problem(torch, n, magnus_order, uniform, device)
                    kwargs["hermitian"] = hermitian
                    if slots:
                        kwargs["eval_slots"] = tuple(
                            s // 4 if s % 4 == 3 else -1 for s in range(DF_STEPS))
                    out = dfs.sweep_expm_magnus_df(*args, chunk_b=16, **kwargs)
                    plain = dfs.sweep_expm_magnus_df_plain(dfs.prepare_df_inputs(*args, **kwargs))
                    torch.cuda.synchronize()
                    pairs = [(out[0], plain[0]), (out[1], plain[1])] if slots else [
                        (out, plain[0])]
                    for got, want in pairs:
                        check(got.dtype == torch.complex128, f"B8 returned {got.dtype}")
                        diff = float((got - want).abs().max())
                        check(diff <= DF_KERNEL_TOL, f"B8 n={n} Magnus-{magnus_order} hermitian="
                              f"{hermitian} slots={slots}: kernel vs plain {diff:.2e}")
                        worst["df"] = max(worst["df"], diff)
        log(f"  B8 n={n:2d}: Magnus-2/3 x hermitian x (uniform, non-uniform + slots) max diff "
            f"{worst['df']:.2e} (running)")
    # member counts; phase arguments near 1e4 rad; the (cos, sin) table layout
    extra = [(f"{members} members", dict(n=16, members=members), True, None)
             for members in DF_MEMBER_COUNTS]
    extra += [("node times near 330", dict(n=13, uniform=False, t0=330.0), hermitian, 16)
              for hermitian in (False, True)]
    extra.append(("n=32 over 300 steps", dict(n=32, members=5, steps=300), True, None))
    for name, problem, hermitian, chunk_b in extra:
        problem = {"uniform": True, **problem}
        args, kwargs = df_kernel_problem(torch, problem.pop("n"), 3, problem.pop("uniform"),
                                         device, **problem)
        kwargs["hermitian"] = hermitian
        inputs = dfs.prepare_df_inputs(*args, **kwargs)
        before = launched(*B8)
        out = dfs.sweep_expm_magnus_df(*args, **kwargs, **({} if chunk_b is None else
                                                            {"chunk_b": chunk_b}))
        plain = dfs.sweep_expm_magnus_df_plain(inputs)[0]
        torch.cuda.synchronize()
        diff = float((out - plain).abs().max())
        launches = launched(*B8) - before
        check(launches == -(-inputs.batch // (chunk_b or 2048)) and diff <= DF_KERNEL_TOL,
              f"B8 {name}: kernel vs plain {diff:.2e}, {launches} launches")
        worst["df"] = max(worst["df"], diff)
    check(not dfs.rotated_tables(32, 2, 3, 300), "the n=32 case did not take the (cos, sin) table")
    for n in PT_DIMS:
        for B in PT_BATCHES:
            for T in (1, 7):
                gen = np.random.default_rng(100 * n + T)
                props = torch.as_tensor(unitary_stack(gen, T, n, B, np.complex128),
                                        device=device)
                y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
                y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=device)
                out, plain = ca.chain_apply_bol(props, y0), ca.chain_apply_bol_plain(props, y0)
                torch.cuda.synchronize()
                check(out.dtype == torch.complex128 and torch.equal(out, plain),
                      f"B5 complex128 n={n} B={B} T={T}: kernel and plain version differ by "
                      f"{float((out - plain).abs().max()):.2e}, not bit for bit")
            planes = unit_planes(torch, np.random.default_rng(n), n, B, dtype=torch.float64,
                                 device=device)
            for order, squarings in PT_EXPM_CASES:
                got = bl.expm_taylor_bol(*planes, order, squarings)
                diff = planes_diff(got, bl.expm_taylor_bol_plain(*planes, order, squarings))
                check(got[0].dtype == torch.float64 and diff <= DF_KERNEL_TOL,
                      f"B6 complex128 n={n} B={B} order={order} squarings={squarings}: kernel "
                      f"vs plain {diff:.2e} > {DF_KERNEL_TOL}")
                worst["expm"] = max(worst["expm"], diff)
    return worst


# --------------------------------------------------------------------------
# phases 15 and 16: the df32 CR rows and the Chebyshev rows
# --------------------------------------------------------------------------
def df_cr_signals(torch, Signal, w1, gaussian=False):
    """The CR df32 rows' signals (``bench.py:284-365``): a constant envelope
    ``amp * AMP_SCALE``, or that times a Gaussian of width T / 5 at T / 2."""
    if gaussian:
        def signals_fn(amp):
            return [Signal(lambda t: amp * AMP_SCALE * torch.exp(
                -((t - T_MAIN / 2) ** 2) / (T_MAIN**2 / 12.5)), carrier_freq=w1)]
    else:
        def signals_fn(amp):
            return [Signal(lambda t: amp * AMP_SCALE, carrier_freq=w1)]
    return signals_fn


def df_probes():
    return np.linspace(0, DF_SWEEP - 1, PROBES).astype(int)


def df_references(solver, signals_fn, params, y0):
    """Final states of ``params`` (one signal-function argument each) by the
    host DOP853 at atol = rtol = 1e-12, and seconds per member."""
    start = time.perf_counter()
    refs = [np.asarray(solver.solve(t_span=[0.0, T_MAIN], y0=y0, signals=signals_fn(p),
                                    method="DOP853", atol=1e-12, rtol=1e-12).y[-1])
            for p in params]
    return np.stack(refs), (time.perf_counter() - start) / len(params)


def df_flops_per_member_step(n: int, k: int, n_nodes: int, hermitian: bool, order: int):
    """FP64 operations of one member-step of kernel B8 as ``(products,
    other)``: the rule's complex matrix products (8 n^3 each), and the
    generator builds, the rule's elementwise terms and the Horner mat-vecs."""
    build = n_nodes * n * n * (4 * k + 6)
    if n_nodes == 2:
        products, elementwise = (1 if hermitian else 2), 8 * n * n
    else:
        products, elementwise = (3 if hermitian else 6), 34 * n * n
    return products * 8 * n**3, build + elementwise + order * (8 * n * n + 4 * n)


def sass_count(library: str, opcode: str) -> int:
    """Instructions named ``opcode`` in the SASS of a built kernel library
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    return sum(1 for line in sass.splitlines() if re.search(rf"\b{opcode}\b", line))


def df_bound(inputs):
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch
    nn = inputs.taus.shape[1]
    products, other = df_flops_per_member_step(n, k, nn, inputs.hermitian, inputs.order)
    nbytes = 8 * T * nn * k * B + 32 * n * B + 16 * (k + 1) * n * n + 8 * (n * n + 4 * T)
    return bound_f64(products * T * B, other * T * B, nbytes)


def phase_df32(torch, dfs, Signal, solver, w1, ref_solver, y0, device="cuda"):
    """Phase 15: the CR df32 rows through ``Solver.solve_sweep(method=
    "fused_magnus2", precision="df32")``, constant and Gaussian envelopes;
    B8 alone and its plain version at the constant row's shape."""
    amps = torch.linspace(0.25, 1.0, DF_SWEEP, dtype=torch.float64, device=device)
    probes = df_probes()
    rows = {}
    for name, gaussian, n_probes in (("df32", False, PROBES), ("df32_gauss", True, 2)):
        signals_fn = df_cr_signals(torch, Signal, w1, gaussian)

        def sweep(signals_fn=signals_fn):
            return solver.solve_sweep(signals_fn, amps, t_span=(0.0, T_MAIN), y0=y0,
                                      method="fused_magnus2", max_dt=DF_MAX_DT, precision="df32")

        sweep()  # warm-up
        torch.cuda.synchronize()
        before = launched(*B8)
        with Capture(dfs) as cap:
            out = sweep()
            torch.cuda.synchronize()
        launches = launched(*B8) - before
        check(launches > 0, f"the {name} row did not launch the df_magnus_sweep kernel")
        check(out.shape == (DF_SWEEP, y0.shape[0]) and out.dtype == torch.complex128,
              f"{name} output {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"non-finite {name} states")
        probe_amps = [torch.tensor(a) for a in amps.cpu().numpy()[probes[:n_probes]]]
        refs, ref_s = df_references(ref_solver, signals_fn, probe_amps, y0)
        err = float(np.max(np.abs(out[probes[:n_probes]].cpu().numpy() - refs)))
        check(err <= DF_TOL, f"{name}_max_err {err:.2e} > {DF_TOL} against DOP853(1e-12)")
        per_call, block_s, reps = steady_time(torch, sweep)
        rows[name] = dict(launches=launches, max_err=err, sims_per_s=DF_SWEEP / per_call,
                          per_call=per_call, block_s=block_s, reps=reps, ref_s=ref_s,
                          refs=refs, inputs=cap.last)
    inputs, chunk_b = rows["df32"].pop("inputs")
    rows["df32_gauss"].pop("inputs")
    kernel_ms = cuda_ms(torch, lambda: dfs._launch_kernel(inputs, chunk_b), reps=3)
    kernel_out = dfs._launch_kernel(inputs, chunk_b)[0]
    plain_ms, plain = timed_ms(torch, lambda: dfs.sweep_expm_magnus_df_plain(inputs, chunk_b))
    diff = float((kernel_out - plain[0]).abs().max())
    check(diff <= DF_KERNEL_TOL, f"df32 row: B8 vs plain {diff:.2e} > {DF_KERNEL_TOL}")
    bound_ms, bound_by = df_bound(inputs)
    n_nodes = inputs.taus.shape[1]
    lib = dfs._LIB
    shape = dfs.launch_shape(inputs.n, inputs.k, n_nodes, inputs.hermitian,
                             min(chunk_b, inputs.batch))
    members_per_sm = shape.members_per_block * lib.df_magnus_sweep_active_blocks(
        inputs.n, inputs.k, n_nodes, int(inputs.hermitian), shape.members_per_block)
    dmma = sass_count(lib.path, "DMMA")
    check(dmma > 0, "B8's library holds no DMMA instruction: its products are not on the FP64 "
                    "tensor cores")
    layout = "rotated" if dfs.rotated_tables(inputs.n, inputs.k, n_nodes, inputs.steps) else (
        "(cos, sin)")
    row, gauss = rows["df32"], rows["df32_gauss"]
    print(
        f"phase 15 df32 CR rows: cr_solver n={inputs.n}, {DF_SWEEP} members, T={T_MAIN}, "
        f"max_dt={DF_MAX_DT} ({inputs.steps} steps of Magnus-3, order {inputs.order}, "
        f"hermitian={inputs.hermitian}): df32_sims_per_s {row['sims_per_s']:.1f} ({row['reps']} "
        f"calls in {row['block_s']:.2f} s, {row['per_call'] * 1e3:.2f} ms/call = kernel "
        f"{kernel_ms:.2f} ms + coefficients and glue {row['per_call'] * 1e3 - kernel_ms:.2f} ms), "
        f"df32_max_err {row['max_err']:.2e} (<= {DF_TOL}, {PROBES} probes vs DOP853 1e-12 at "
        f"{row['ref_s']:.2f} s/sim); B8 {kernel_ms:.3f} ms over {len(range(0, DF_SWEEP, chunk_b))} "
        f"launches (bound {bound_ms:.3f} ms, {bound_by}), plain {plain_ms:.1f} ms, kernel vs "
        f"plain {diff:.2e}, {members_per_sm} members = {members_per_sm} warps resident per SM "
        f"({shape.members_per_block} per block), {dmma} DMMA instructions in its SASS, "
        f"{layout} tables; launches {row['launches']}; Gaussian envelope: df32_gauss_sims_per_s "
        f"{gauss['sims_per_s']:.1f}, df32_gauss_max_err {gauss['max_err']:.2e} (2 probes); "
        f"launches {gauss['launches']}",
        flush=True,
    )
    return dict(launches=row["launches"], max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, rows=rows, members_per_sm=members_per_sm,
                dmma_sass_count=dmma)


def phase_chebyshev(torch, dfs, Signal, solver, w1, ref_solver, y0, df_refs, device="cuda"):
    """Phase 16: the 1-d Chebyshev row over the df32 row's amplitudes (its
    references reused) and the 2-d amplitude x detuning map."""
    amps = torch.linspace(0.25, 1.0, DF_SWEEP, dtype=torch.float64, device=device)
    kw = dict(t_span=(0.0, T_MAIN), y0=y0, method="chebyshev", tol=CHEB_TOL, max_dt=DF_MAX_DT,
              full_output=True)
    signals_fn = df_cr_signals(torch, Signal, w1)

    def sweep():
        return solver.solve_sweep(signals_fn, amps, min_level=4, **kw)

    sweep()
    torch.cuda.synchronize()
    before = launched(*B8)
    out, info = sweep()
    torch.cuda.synchronize()
    launches = launched(*B8) - before
    check(launches > 0 and info.converged, "the Chebyshev row did not run B8 or did not converge")
    err = float(np.max(np.abs(out[df_probes()].cpu().numpy() - df_refs)))
    check(err <= DF_TOL, f"cheb_max_err {err:.2e} > {DF_TOL} against DOP853(1e-12)")
    per_call, block_s, reps = steady_time(torch, sweep)

    def map_fn(pq):
        amp, det = pq
        return [Signal(lambda t: amp * AMP_SCALE, carrier_freq=w1 + det)]

    map_amps = torch.linspace(0.25, 1.0, CHEB_MAP, dtype=torch.float64, device=device)
    map_dets = torch.linspace(-CHEB_DETUNING, CHEB_DETUNING, CHEB_MAP, dtype=torch.float64,
                              device=device)

    def map_sweep():
        return solver.solve_sweep(map_fn, (map_amps, map_dets), min_level=3, max_level=7, **kw)

    map_sweep()
    torch.cuda.synchronize()
    before = launched(*B8)
    map_out, map_info = map_sweep()
    torch.cuda.synchronize()
    map_launches = launched(*B8) - before
    check(map_launches > 0 and map_info.converged, "the 2-d map did not run B8 or converge")
    check(map_out.shape == (CHEB_MAP, CHEB_MAP, y0.shape[0]), f"map shape {map_out.shape}")
    corners = ((0, 0), (CHEB_MAP // 2, CHEB_MAP // 2), (CHEB_MAP - 1, CHEB_MAP - 1))
    a_np, d_np = map_amps.cpu().numpy(), map_dets.cpu().numpy()
    map_refs, map_ref_s = df_references(
        ref_solver, map_fn,
        [(torch.tensor(a_np[i]), torch.tensor(d_np[j])) for i, j in corners], y0)
    map_err = float(np.max(np.abs(
        np.stack([map_out[i, j].cpu().numpy() for i, j in corners]) - map_refs)))
    check(map_err <= DF_TOL, f"cheb2d_max_err {map_err:.2e} > {DF_TOL} against DOP853(1e-12)")
    map_call, map_block, map_reps = steady_time(torch, map_sweep)
    result = dict(sims_per_s=DF_SWEEP / per_call, nodes=info.n_nodes, max_err=err,
                  launches=launches, map_sims_per_s=CHEB_MAP**2 / map_call,
                  map_nodes=map_info.n_nodes, map_max_err=map_err, map_launches=map_launches)
    print(
        f"phase 16 Chebyshev rows: 1-d over the {DF_SWEEP} df32 amplitudes, tol {CHEB_TOL}, "
        f"min_level 4: cheb_sweep_sims_per_s {result['sims_per_s']:.1f} ({reps} calls in "
        f"{block_s:.2f} s, {per_call * 1e3:.2f} ms/call), cheb_nodes {info.n_nodes} (levels "
        f"{info.levels}, certified {info.est_error:.2e}), cheb_max_err {err:.2e} (<= {DF_TOL}, "
        f"{PROBES} probes, phase 15's references), B8 launches {launches}; 2-d map "
        f"{CHEB_MAP} x {CHEB_MAP} amplitude x detuning (+-{CHEB_DETUNING}): "
        f"cheb2d_sims_per_s {result['map_sims_per_s']:.1f} ({map_reps} calls in "
        f"{map_block:.2f} s), cheb2d_nodes {map_info.n_nodes} (levels {map_info.levels}, "
        f"certified {map_info.est_error:.2e}), cheb2d_max_err {map_err:.2e} (<= {DF_TOL}, 3 probes "
        f"vs DOP853 1e-12 at {map_ref_s:.2f} s/sim), B8 launches {map_launches}",
        flush=True,
    )
    return result


# --------------------------------------------------------------------------
# phase 17: the FP64 Dysolve (Dyson and Magnus rows in complex128)
# --------------------------------------------------------------------------
def dysolve_df_sweep(torch, Signal, solver, nu, amps):
    """The FP64 Dysolve sweep of ``solver`` over BASELINE config 4's
    Gaussian amplitudes: ``solve_sweep(precision="df32")`` in chunks of
    DF_CHUNK members."""
    y0, signals_fn, _, _ = perturbative_sweep(torch, Signal, solver, nu, amps)

    def sweep():
        return solver.solve_sweep(0.0, PT_STEPS, y0, signals_fn, amps, precision="df32",
                                  df_chunk_b=DF_CHUNK)

    return sweep


def phase_dysolve_df(torch, ca, bl, Signal, make_solver, name, refs, ref_s, device="cuda",
                     **config):
    """One FP64 Dysolve row at full width: the complex state at the three
    probes against DOP853(1e-12) in the frame of G0 (phase 12's references),
    the complex128 chain and (Magnus) expm kernels counted, and both timed
    alone at the row's shapes beside their plain versions."""
    start = time.perf_counter()
    solver, nu = make_solver(device=device, **config)
    build_s = time.perf_counter() - start
    magnus = solver.model.expansion_method == "magnus"
    terms = len(solver.model.expansion_polynomial.monomial_labels)
    amps = torch.linspace(0.2, 1.0, PT_SWEEP, dtype=torch.float64, device=device)
    sweep = dysolve_df_sweep(torch, Signal, solver, nu, amps)
    sweep()
    torch.cuda.synchronize()
    before = [launched("chain_apply_launch"), launched("expm_bol_launch")]
    with Capture(ca) as cap_chain, Capture(bl) as cap_linalg:
        out = sweep()
        torch.cuda.synchronize()
    counts = [launched("chain_apply_launch") - before[0], launched("expm_bol_launch") - before[1]]
    chunks = -(-PT_SWEEP // DF_CHUNK)
    check(counts[0] == chunks, f"the {name} row launched the chain kernel {counts[0]} times, "
          f"not {chunks}")
    check(counts[1] == (chunks if magnus else 0), f"the {name} row launched the expm kernel "
          f"{counts[1]} times")
    check(out.shape == (PT_SWEEP, PT_DIM) and out.dtype == torch.complex128,
          f"{name} output {tuple(out.shape)} {out.dtype}")
    err = float(np.max(np.abs(out[perturbative_probes()].cpu().numpy() - refs)))
    check(err <= DF_TOL, f"{name}_max_err {err:.2e} > {DF_TOL} against DOP853(1e-12)")
    per_call, block_s, reps = steady_time(torch, sweep)

    props, y0_cols = cap_chain.last
    chain_ms = cuda_ms(torch, lambda: ca._launch_kernel(props, y0_cols), reps=5)
    chain_out = ca._launch_kernel(props, y0_cols)
    chain_plain_ms, chain_plain = timed_ms(torch, lambda: ca.chain_apply_bol_plain(props, y0_cols))
    chain_diff = float((chain_out - chain_plain).abs().max())
    check(torch.equal(chain_out, chain_plain), f"{name}: complex128 chain kernel and plain "
          f"version differ by {chain_diff:.2e}")
    T, n, _, B = props.shape
    chain_bound = bound_f64(0.0, 8.0 * T * n * n * B, 16.0 * T * n * n * B + 32.0 * n * B)
    result = dict(chain=dict(launches=counts[0], max_abs_err=chain_diff, ms=chain_ms,
                             plain_ms=chain_plain_ms, bound_ms=chain_bound[0],
                             bound_by=chain_bound[1], library_ms=None),
                  sims_per_s=PT_SWEEP / per_call, max_err=err, terms=terms)
    del props, y0_cols, chain_out, chain_plain
    text = ""
    if magnus:
        which, planes, order, squarings = cap_linalg.last
        lanes = planes[0].shape[2]
        expm_ms = cuda_ms(torch, lambda: bl._launch_kernel(which, planes, order, squarings), reps=3)
        expm_out = bl._launch_kernel(which, planes, order, squarings)
        expm_plain_ms, expm_plain = timed_ms(
            torch, lambda: bl.expm_taylor_bol_plain(*planes, order, squarings))
        expm_diff = planes_diff(expm_out, expm_plain)
        check(expm_diff <= DF_KERNEL_TOL,
              f"{name}: complex128 expm kernel vs plain {expm_diff:.2e}")
        del expm_plain
        stack = bl.from_bol(*planes).contiguous()
        torch.linalg.matrix_exp(stack[:1024])
        library_ms, library = timed_ms(torch, lambda: torch.linalg.matrix_exp(stack))
        library_diff = float((library - bl.from_bol(*expm_out)).abs().max())
        del stack, library, expm_out
        expm_bound = bound_f64((order - 1 + squarings) * 8.0 * n**3 * lanes, 0.0,
                               32.0 * n * n * lanes)
        # the kernel runs its products on the FP64 FMA pipes, not the tensor cores
        fma_bound = bound((order - 1 + squarings) * 8.0 * n**3 * lanes, 32.0 * n * n * lanes,
                          PEAK_F64)
        shape, shape_text = bl_launch(bl, "expm", n, lanes, double=True)
        result["expm"] = dict(launches=counts[1], max_abs_err=expm_diff, ms=expm_ms,
                              plain_ms=expm_plain_ms, bound_ms=expm_bound[0],
                              bound_by=expm_bound[1], library_ms=library_ms,
                              bound_fma_pipes_ms=fma_bound[0], shape=dataclasses.asdict(shape),
                              warps_per_sm=shape.warps_per_sm)
        text = (f"complex128 expm kernel {expm_ms:.3f} ms over {lanes} lanes per pass (bound "
                f"{expm_bound[0]:.3f} ms on the FP64 tensor cores, {fma_bound[0]:.3f} ms on the "
                f"FP64 FMA pipes, {expm_bound[1]}), plain {expm_plain_ms:.1f} ms, "
                f"torch.linalg.matrix_exp {library_ms:.1f} ms (differs by {library_diff:.2e}), "
                f"kernel vs plain {expm_diff:.2e}, launch: {shape_text}; ")
        del planes
    torch.cuda.empty_cache()
    print(
        f"phase 17 {name} row: {type(solver).__name__} {config}, {terms} monomials "
        f"(precompute {build_s:.1f} s), {PT_SWEEP} members x {PT_STEPS} steps in passes of "
        f"{DF_CHUNK}: {name}_sims_per_s {PT_SWEEP / per_call:.1f} ({reps} calls in "
        f"{block_s:.2f} s, {per_call * 1e3:.1f} ms/call); {name}_max_err {err:.2e} (complex "
        f"state, <= {DF_TOL}, 3 probes vs DOP853 1e-12 at {ref_s:.2f} s/sim); complex128 chain "
        f"kernel {chain_ms:.3f} ms per pass (bound {chain_bound[0]:.3f} ms, {chain_bound[1]}), "
        f"plain {chain_plain_ms:.1f} ms, kernel vs plain {chain_diff:.2e} (bitwise equal); {text}"
        f"launches [chain, expm] {counts}",
        flush=True,
    )
    return result


# --------------------------------------------------------------------------
# phase 18: the fused expm chain (kernel B9) at bench.py's cell
# --------------------------------------------------------------------------
def unitary_generators(torch, T, b, n, dtype, device="cuda", seed=0):
    """(T, b, n, n) anti-Hermitian generators of Frobenius norm 2, as
    bench.py makes the cell's (here on the card, from a torch seed)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((T, b, n, n), generator=gen, dtype=torch.complex128, device=device)
    a = -0.5j * (a + a.conj().transpose(-1, -2))
    a = a / torch.linalg.matrix_norm(a, keepdim=True) * 2.0
    return a.to(dtype)


def expm_chain_work(T, b, n, m, order, squarings, entry_bytes):
    """(operations, bytes) of a chain: per step the Paterson-Stockmeyer
    products, the squarings and the apply, 8 real operations per complex
    multiply-add; each generator read once, y0 read and the result written once."""
    s = max(2, math.isqrt(order))
    top = -(-(order + 1) // s) - 1
    horner = top - 1 if s * top == order else top
    square_products = (s - 1) + horner + squarings
    flops = T * b * (square_products * 8 * n**3 + 8 * n * n * m)
    nbytes = entry_bytes * (T * b * n * n + 2 * b * n * m)
    return flops, nbytes


def phase_expm_chain(torch, ecp, expm_chain, device="cuda"):
    """B9 at the cell: both engines timed, their checksum, B9 against its
    plain version, at n = 100 and in complex128; the launch count."""
    start = time.perf_counter()
    gens = unitary_generators(torch, EC_T, EC_B, EC_N, torch.complex64, device=device)
    y0 = torch.eye(EC_N, dtype=torch.complex64, device=device).expand(EC_B, EC_N, EC_N)
    y0 = y0.contiguous()

    def run(engine):
        return expm_chain(gens, EC_DT, y0, order=EC_ORDER, squarings=EC_SQUARINGS, engine=engine)

    run("pallas")  # warm-up: the first launch
    torch.cuda.synchronize()
    before = launched("expm_chain_launch")
    fused = run("pallas")
    torch.cuda.synchronize()
    launches = launched("expm_chain_launch") - before
    check(launches == 1, f"expm_chain(engine='pallas') launched B9 {launches} times, not once")
    xla = run("xla")
    check(fused.shape == (EC_B, EC_N, EC_N) and bool(torch.isfinite(
        torch.view_as_real(fused)).all()), f"B9 output {tuple(fused.shape)} not finite")
    sums = [float(y.abs().double().sum()) for y in (fused, xla)]  # summed in float64
    checksum_rel = abs(sums[0] - sums[1]) / abs(sums[1])
    check(checksum_rel <= EC_CHECKSUM_TOL, f"expm chain checksum: pallas {sums[0]} vs xla "
          f"{sums[1]}, relative {checksum_rel:.2e} > {EC_CHECKSUM_TOL}")
    plain = ecp.expm_chain_fused_plain(gens, EC_DT, y0, EC_ORDER, EC_SQUARINGS)
    diff = float((fused - plain).abs().max())
    check(diff <= EC_PLAIN_TOL, f"B9 vs plain at the cell {diff:.2e} > {EC_PLAIN_TOL}")
    unitarity = float((fused @ fused.conj().transpose(-1, -2) - y0).abs().max())

    per_call = {}
    for engine in ("pallas", "xla"):
        per_call[engine], block_s, reps = steady_time(torch, lambda e=engine: run(e))
        log(f"  expm chain [{engine}]: {per_call[engine] * 1e3:.3f} ms per call ({reps} calls in "
            f"a {block_s:.2f} s block)")
    kernel_ms = cuda_ms(torch, lambda: run("pallas"), reps=5)
    library_ms = cuda_ms(torch, lambda: run("xla"), reps=5)
    plain_ms = cuda_ms(
        torch, lambda: ecp.expm_chain_fused_plain(gens, EC_DT, y0, EC_ORDER, EC_SQUARINGS), 5)
    flops, nbytes = expm_chain_work(EC_T, EC_B, EC_N, EC_N, EC_ORDER, EC_SQUARINGS, 8)
    bound_ms, bound_by = bound(flops, nbytes)

    # unaligned n, and complex128, against the plain version
    extra = {}
    for name, (T, b, n, m, dtype, tol) in {
        "n100_c64": (16, 3, 100, 37, torch.complex64, 2e-5),
        "n64_c128": (8, 2, 64, 5, torch.complex128, 1e-12),
    }.items():
        g = unitary_generators(torch, T, b, n, dtype, device=device, seed=n)
        y = torch.linalg.qr(torch.randn((b, n, m), dtype=torch.complex128, device=device))[0]
        y = y.to(dtype)
        got = ecp.expm_chain_fused(g, EC_DT, y, EC_ORDER, EC_SQUARINGS)
        want = ecp.expm_chain_fused_plain(g, EC_DT, y, EC_ORDER, EC_SQUARINGS)
        extra[name] = float((got - want).abs().max())
        check(extra[name] <= tol, f"B9 {name} vs plain {extra[name]:.2e} > {tol}")
    us = {e: per_call[e] / (EC_T * EC_B) * 1e6 for e in per_call}
    print(
        f"phase 18 expm chain (B9): T={EC_T}, b={EC_B}, n=m={EC_N}, order {EC_ORDER}, "
        f"squarings {EC_SQUARINGS}, complex64: pallas {us['pallas']:.2f} us/expm+apply "
        f"({per_call['pallas'] * 1e3:.3f} ms/call), xla (cuBLAS loop) {us['xla']:.2f} "
        f"us/expm+apply ({per_call['xla'] * 1e3:.3f} ms/call); kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP); "
        f"checksum rel {checksum_rel:.2e} (<= {EC_CHECKSUM_TOL}); B9 vs plain {diff:.2e} (<= "
        f"{EC_PLAIN_TOL}), n=100 {extra['n100_c64']:.2e} (<= 2e-5), complex128 n=64 "
        f"{extra['n64_c128']:.2e} (<= 1e-12); max |U U^H - I| {unitarity:.2e}; launches "
        f"{launches}; in {time.perf_counter() - start:.1f} s",
        flush=True,
    )
    return dict(launches=launches, max_abs_err=diff, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                pallas_us_per_expm=us["pallas"], xla_us_per_expm=us["xla"],
                checksum_rel=checksum_rel)


# --------------------------------------------------------------------------
# phase 19: the solver surface on the card (the CR Solver, device methods)
# --------------------------------------------------------------------------
def solver_surface_problem(Signal, w1, dim):
    """The CR drive of phase 4 at amplitude 1 (0.02 after AMP_SCALE) and e_0."""
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0
    return [Signal(AMP_SCALE, carrier_freq=w1)], y0


def phase_solver_surface(torch, Signal, solver, w1, ref_solver, device="cuda"):
    """Each method of SV_METHODS once over SV_T against the host DOP853(1e-10)."""
    signals, y0 = solver_surface_problem(Signal, w1, solver.model.dim)
    start = time.perf_counter()
    ref = ref_solver.solve(t_span=[0.0, SV_T], y0=y0, signals=signals, method="DOP853",
                           atol=1e-10, rtol=1e-10)
    ref_s = time.perf_counter() - start
    ref_pop = np.abs(ref.y[-1]) ** 2
    rows = {}
    for method, kwargs, bar in SV_METHODS:
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = solver.solve(t_span=[0.0, SV_T], y0=y0, signals=signals, method=method, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        check(isinstance(res.y, torch.Tensor) and res.y.device.type == device,
              f"{method}: the result is not a tensor on the {device} device")
        pop = (res.y[-1].abs() ** 2).cpu().numpy()
        err = float(np.max(np.abs(pop - ref_pop)))
        check(bool(np.isfinite(pop).all()) and err <= bar,
              f"{method}: population error {err:.2e} > {bar} against DOP853(1e-10)")
        if "nfev" in res:  # attempted steps: 6 (dopri5) or 12 (DOP853) evaluations each
            steps = (int(res.nfev) - 2) // (6 if method == "tpu_dopri5" else 12)
        else:
            steps = int(np.ceil(SV_T / kwargs["max_dt"]))
        rows[method] = dict(s=seconds, err=err, steps=steps)
        log(f"  {method} {kwargs}: {seconds:.2f} s, err {err:.2e} (<= {bar}), steps {steps}")
    print(
        f"phase 19 solver surface: cr_solver n={solver.model.dim} (frame, RWA), T={SV_T}, "
        + "; ".join(
            f"{m} {r['s']:.2f} s, {r['steps']} steps, err {r['err']:.2e} (<= {bar})"
            for (m, _, bar), r in zip(SV_METHODS, rows.values())
        )
        + f"; host DOP853(1e-10) {ref_s:.2f} s",
        flush=True,
    )
    return rows


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        log("phase 1 device: FAILED, torch.cuda.is_available() is false")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)

    from qiskit_dynamics_tpu_torch import Signal, Solver, interop, solve_ode
    from qiskit_dynamics_tpu_torch.benchmarks import (
        cr_solver,
        expm_chain,
        dyson_transmon_solver,
        lindblad_qudit_solver,
        lindblad_two_transmon_solver,
        magnus_transmon_solver,
    )
    from qiskit_dynamics_tpu_torch.kernels import _build
    from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw
    from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
    from qiskit_dynamics_tpu_torch.ops import chain_apply as ca
    from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs
    from qiskit_dynamics_tpu_torch.ops import expm_chain_pallas as ecp
    from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp
    from qiskit_dynamics_tpu_torch.ops import member_sweep as msw
    from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw
    from qiskit_dynamics_tpu_torch.solvers.fused_sweep import (
        _expand_lanes,
        fused_sweep_solve,
        sweep_arguments,
    )

    # phase 2: build the ten kernel sources, one nvcc each, in parallel
    start = time.perf_counter()
    names = ("adaptive_sweep", "sweep_magnus2", "member_sweep", "horner_apply", "chain_apply",
             "batched_linalg", "df_magnus_sweep", "df_magnus_wide", "expm_chain",
             "monomial_contract")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.load, names))
    check(all(lib is not None for lib in libs), "a kernel library did not load")
    build_s = time.perf_counter() - start
    reports = []
    for name, lib in zip(names, libs):
        report = Path(lib._name + ".ptxas.txt")  # the library this run loaded
        reports.append(f"{name}: " + " ".join(
            line.strip() for line in (report.read_text().splitlines() if report.exists() else [])
            if "registers" in line or "spill" in line
        )[:400])
    print(f"phase 2 build: {', '.join(names)} built in {build_s:.2f} s; " + "; ".join(reports),
          flush=True)

    # phase 3: kernel against twin, every mode, every n
    start = time.perf_counter()
    state_diff, step_rel = phase_modes(torch, asw, _expand_lanes)
    forced = phase_clusters(torch, asw)
    print(f"phase 3 kernel vs twin: 5 modes x n in {DIMS} agree (max state diff "
          f"{state_diff:.2e} <= 1e-5, max step rel {step_rel:.2e} <= 1e-5); n = 16, tile_b = "
          f"512 over clusters of {B1_CLUSTERS} blocks ((G, P, R, threads, members per group) "
          f"{[(s.cluster, s.lanes, s.rows, s.threads, s.members_per_group) for s in forced]}), "
          f"constant and table modes, bit for bit with equal step records, in "
          f"{time.perf_counter() - start:.1f} s", flush=True)

    # phase 4: the main path at full width
    cuda = torch.device("cuda")
    solver, w1 = cr_solver(device=cuda)
    dim = solver.model.dim
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0
    amps = torch.linspace(0.25, 1.0, SWEEP, dtype=torch.float64, device=cuda)

    def signals_fn(amp):
        return [Signal(lambda t: amp * AMP_SCALE, carrier_freq=w1)]

    def sweep():
        return solver.solve_sweep(
            signals_fn, amps, t_span=(0.0, T_MAIN), y0=y0, method="fused_dopri5",
            atol=MAIN_TOL, rtol=MAIN_TOL, h0=0.1,
        )

    sweep()  # warm-up: first launch, allocator
    torch.cuda.synchronize()
    before = launched("adaptive_sweep_launch")
    out = sweep()
    torch.cuda.synchronize()
    launches = launched("adaptive_sweep_launch") - before
    check(launches > 0, "the main path did not launch the adaptive_sweep kernel")
    pops = (out.abs() ** 2).cpu().numpy()
    check(pops.shape == (SWEEP, dim), f"output shape {pops.shape} != {(SWEEP, dim)}")
    check(bool(np.isfinite(pops).all()), "non-finite populations in the main path")
    norm_dev = float(np.max(np.abs(pops.sum(axis=1) - 1.0)))

    ref_solver, _ = cr_solver(device="cpu")  # float64 on the host
    probe_idx = np.linspace(0, SWEEP - 1, PROBES).astype(int)
    start = time.perf_counter()
    ref_pops = []
    for a in amps.cpu().numpy()[probe_idx]:
        res = ref_solver.solve(
            t_span=[0.0, T_MAIN], y0=y0, method="DOP853", atol=1e-8, rtol=1e-8,
            signals=[Signal(lambda t, a=a: a * AMP_SCALE, carrier_freq=w1)],
        )
        ref_pops.append(np.abs(res.y[-1]) ** 2)
    dop853_s = (time.perf_counter() - start) / PROBES
    max_err = float(np.max(np.abs(pops[probe_idx] - np.asarray(ref_pops))))
    check(max_err <= 1e-5, f"cr_sweep_max_err {max_err:.2e} > 1e-5 against DOP853(1e-8)")

    per_call, block_s, reps = steady_time(torch, sweep)
    sims_per_s = SWEEP / per_call

    # kernel alone and twin at the main path's shape (the inputs solve_sweep builds)
    args, kwargs, _ = sweep_arguments(
        solver.model, signals_fn, amps, (0.0, T_MAIN), y0, atol=MAIN_TOL, rtol=MAIN_TOL,
        max_steps=4096, h0=0.1, tile_b=512, rwa_signal_map=solver._rwa_signal_map,
        envelope_resolution=None, bucket_lanes=True, t_eval=None,
    )
    inputs = asw.prepare_inputs(*args, **kwargs)
    kernel_ms = cuda_ms(torch, lambda: asw._launch_kernel(inputs, False), reps=3)
    kernel_out = asw._launch_kernel(inputs, False)[0]
    twin_ms, twin = timed_ms(torch, lambda: asw.sweep_dopri5_lockstep_plain(inputs))
    twin_out = twin[0]
    main_diff = float((kernel_out - twin_out).abs().max())
    check(main_diff <= 1e-5, f"main-path kernel vs twin diff {main_diff:.2e} > 1e-5")
    host_ms = per_call * 1e3 - kernel_ms
    # the bound counts this run's accepted steps (the kernel's step record)
    b1_steps = torch.zeros(inputs.batch // inputs.tile_b, dtype=torch.int32, device=cuda)
    record = asw._launch_kernel(inputs, True, steps_out=b1_steps)[2].cpu().numpy()
    accepted = (record > 0).sum(axis=1)
    b1_bytes = 4 * (2 * inputs.k * inputs.batch + 4 * dim * inputs.batch)
    b1_flops = adaptive_dopri5.flops(dim, inputs.k, inputs.tile_b, accepted)
    b1_bound_ms, b1_bound_by = bound(b1_flops, b1_bytes)
    b1_shape = asw.launch_shape(dim, inputs.k, inputs.tile_b)
    b1_clusters = asw.active_clusters(dim, inputs.k, inputs.tile_b)
    b1_steps_max = int(b1_steps.max())
    b1_us_per_step = kernel_ms * 1e3 / b1_steps_max
    report = Path(asw._LIB.path + ".ptxas.txt")  # the library the launch loaded
    # the instantiation the launch took: rows, two operators or any, n = 16 compile-time
    two = inputs.k == 2
    compiled_n = 16 if two and dim == 16 and b1_shape.lanes * b1_shape.rows == 16 else 0
    b1_ptxas = ptxas_entry(report.read_text() if report.exists() else "",
                           f"ILi{b1_shape.rows}ELi{2 if two else 0}ELi{compiled_n}EE")
    print(
        f"phase 4 main path: cr_solver n={dim}, {SWEEP} members, T={T_MAIN}, tol {MAIN_TOL}: "
        f"{sims_per_s:.1f} sims/s ({reps} calls in a {block_s:.2f} s block, "
        f"{per_call * 1e3:.2f} ms/call = kernel {kernel_ms:.2f} ms + host prep and glue "
        f"{host_ms:.2f} ms); twin {twin_ms:.1f} ms; kernel vs twin {main_diff:.2e}; "
        f"cr_sweep_max_err {max_err:.2e} (<= 1e-5, {PROBES} probes vs DOP853 1e-8 at "
        f"{dop853_s:.2f} s/sim); max |norm - 1| {norm_dev:.2e}; launches {launches}; "
        f"accepted steps per tile mean {accepted.mean():.1f} max {accepted.max()}, bound "
        f"{b1_bound_ms:.3f} ms ({b1_bound_by}); shape G={b1_shape.cluster} P={b1_shape.lanes} "
        f"R={b1_shape.rows} threads={b1_shape.threads} (members per group "
        f"{b1_shape.members_per_group}, {b1_shape.stages_per_pass} stages per table pass, "
        f"{b1_shape.smem_bytes} B shared), {b1_clusters} clusters co-resident, ptxas: {b1_ptxas}; "
        f"steps per tile (rejected included) max {b1_steps_max}, {b1_us_per_step:.2f} us per step",
        flush=True,
    )

    # phase 5: fixed-step kernel against its plain version
    start = time.perf_counter()
    b2_diff, b2_bitwise, b2_launches = phase_b2_modes(torch, ssw, _expand_lanes)
    print(f"phase 5 sweep_magnus2 vs plain: {len(B2_MODES)} modes + trajectory x n in "
          f"{B2_DIMS} agree (max diff {b2_diff:.2e} <= {B2_TOL}; bitwise, not required: "
          f"{b2_bitwise}); launches (matrix_herm): {' | '.join(b2_launches)}; in "
          f"{time.perf_counter() - start:.1f} s", flush=True)

    # phase 6: the CR sweep gradient; phase 7: Lindblad config 3
    grad = phase_grad(torch, ssw, Signal, cr_solver)
    lind = phase_lindblad(torch, ssw, Signal, Solver)

    # phase 8: the member-sweep and Horner kernels against their plain versions
    start = time.perf_counter()
    b3_diff, b4_diff, b3_bracket = phase_large_dim_kernels(torch, msw, hp)
    print(f"phase 8 member_sweep and horner_apply vs plain: member sweep Magnus-2 x n in "
          f"{B3_DIMS2} and Magnus-3 x n in {B3_DIMS3}, hermitian on and off (max diff "
          f"{b3_diff:.2e}); member sweep bracket-dominated at (magnus, n) in "
          f"{B3_BRACKET_CASES}, hermitian on and off, vs complex128 {b3_bracket:.2e} (<= "
          f"{B3_BRACKET_TOL}; single-pass TF32 fails it); horner (n, order, members, "
          f"streaming forced) in {B4_CASES} (max diff {b4_diff:.2e}); all <= {B3_TOL} "
          f"(float32 roundoff: the kernels sum in another "
          f"order than torch.matmul) in {time.perf_counter() - start:.1f} s", flush=True)

    # phase 9: Lindblad dim 8, both rows, one set of host references
    l8_solver, l8_rho0, l8_carrier = lindblad_qudit_solver(device=cuda)
    l8_host, _, _ = lindblad_qudit_solver(device="cpu")
    l8_amps = np.linspace(0.2, 1.0, L8_SWEEP)[[0, L8_SWEEP // 2, L8_SWEEP - 1]]
    l8_refs, l8_ref_s = host_references(Signal, l8_host, l8_rho0, l8_carrier, l8_amps, L8_T)
    l8 = [
        phase_lindblad8(torch, msw, Signal, l8_solver, l8_rho0, l8_carrier, l8_refs, l8_ref_s,
                        magnus, max_dt, limit)
        for magnus, max_dt, limit in L8_ROWS
    ]

    # phase 10: Lindblad dim 256 through the polynomial engine
    l256 = phase_lindblad256(torch, hp, Signal, lindblad_two_transmon_solver)

    # phase 11: the perturbative kernels against their plain versions
    start = time.perf_counter()
    pt_diffs = phase_perturbative_kernels(torch, ca, bl)
    pt_past, pt_past_ms = perturbative_past_64(torch, ca, bl, Signal, interop)
    print(f"phase 11 chain_apply, matmul_bol, expm_taylor_bol and expm_taylor_bol_bwd vs plain: "
          f"n in {PT_DIMS} x lanes in {PT_BATCHES}, chains of 1 and 7 steps (bitwise equal), "
          f"matmul (max diff {pt_diffs['matmul']:.2e}), expm and its backward at (order, "
          f"squarings) in {PT_EXPM_CASES} (max diff {pt_diffs['expm']:.2e}, "
          f"{pt_diffs['expm_bwd']:.2e}); all <= {PT_KERNEL_TOL}; past n = 64 (n = 65 and 100: the "
          f"four kernels, the _ad gradients; Dyson and Magnus solve_sweep at 65) the kernels vs "
          f"the CPU's plain versions {pt_past:.2e} <= {PAST_64_TOL}; at n = 100 x 256 lanes, "
          f"kernel / plain on the card: " + ", ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f} ms" + (
                  f" (bound {v[2]:.3f} ms, {v[3]}; library {v[4]:.3f} ms)" if len(v) > 2 else "")
              for k, v in pt_past_ms.items())
          + f" (libraries: torch.einsum, torch.linalg.matrix_exp, and matrix_exp of the block "
          f"[[X^H, G], [0, X^H]]); B6/B7 ragged at n in {PT_LANE_DIMS} x lanes in "
          f"{PT_LANE_BATCHES}; every launch counted; in {time.perf_counter() - start:.1f} s",
          flush=True)

    # phases 12 and 13: the Dyson and Magnus rows, one set of host references
    pt_amps = np.linspace(0.2, 1.0, PT_SWEEP)[perturbative_probes()]
    pt_refs, pt_ref_s = perturbative_references(solve_ode, pt_amps)
    dyson = phase_perturbative_row(torch, 12, "dyson", dyson_transmon_solver, Signal, ca, bl,
                                   pt_refs, pt_ref_s)
    magnus = phase_perturbative_row(torch, 13, "magnus", magnus_transmon_solver, Signal, ca, bl,
                                    pt_refs, pt_ref_s)

    # phase 14: the FP64 kernels against their plain versions
    start = time.perf_counter()
    df_diffs = phase_df_kernels(torch, dfs, ca, bl)
    df_past, df_past_ms = df_past_32(torch, dfs, Signal, lindblad_qudit_solver, fused_sweep_solve)
    print(f"phase 14 df_magnus_sweep, and chain_apply and expm_taylor_bol in complex128, vs plain: "
          f"B8 n in {DF_DIMS} x Magnus-2/3 x hermitian on/off x (uniform dt; non-uniform dt with "
          f"eval_slots), {DF_MEMBERS} members in launches of 16, {DF_MEMBER_COUNTS} members at "
          f"n = 16, phases near 1e4 rad, the (cos, sin) table at n = 32 (max diff "
          f"{df_diffs['df']:.2e}); "
          f"chain n in {PT_DIMS} x lanes in {PT_BATCHES} x 1 and 7 steps, bitwise equal; expm "
          f"at (order, squarings) in {PT_EXPM_CASES} (max diff {df_diffs['expm']:.2e}); B8's "
          f"wide sweep (n = 33 and 46, and df32 Lindblad solve_dim 36) vs the CPU's plain "
          f"version {df_past:.2e}, over 256 members x 12 Magnus-3 steps kernel / plain on the "
          f"card " + ", ".join(f"n = {n} {a:.3f} / {b:.3f} ms" for n, (a, b) in df_past_ms.items())
          + f"; all <= {DF_KERNEL_TOL} in "
          f"{time.perf_counter() - start:.1f} s", flush=True)

    # phases 15 and 16: the df32 CR rows and the Chebyshev rows, on phase 4's
    # model, one set of host references
    df32 = phase_df32(torch, dfs, Signal, solver, w1, ref_solver, y0)
    cheb = phase_chebyshev(torch, dfs, Signal, solver, w1, ref_solver, y0,
                           df32["rows"]["df32"]["refs"])

    # phase 17: the FP64 Dysolve rows, phase 12's references
    dyson_df = phase_dysolve_df(torch, ca, bl, Signal, dyson_transmon_solver, "dyson_df",
                                pt_refs, pt_ref_s, chebyshev_order=2, expansion_order=5)
    magnus_df = phase_dysolve_df(torch, ca, bl, Signal, magnus_transmon_solver, "magnus_df",
                                 pt_refs, pt_ref_s, **MAGNUS_DF)

    # phase 18: the fused expm chain; phase 19: the solver surface on phase 4's model
    chain = phase_expm_chain(torch, ecp, expm_chain)
    phase_solver_surface(torch, Signal, solver, w1, ref_solver)

    kernels = [{
        "name": "adaptive_sweep",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/adaptive_sweep.cu",
        "replaces": "qiskit_dynamics_tpu/ops/adaptive_sweep.py:67",
        "launches": launches,
        "max_abs_err": main_diff,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
        "bound_ms": b1_bound_ms,
        "bound_by": b1_bound_by,
        "library_ms": None,
        "shape": dataclasses.asdict(b1_shape),
        "clusters_resident": b1_clusters,
        "steps_max": b1_steps_max,
        "us_per_step": b1_us_per_step,
    }, {
        "name": "sweep_magnus2",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/sweep_magnus2.cu",
        "replaces": "qiskit_dynamics_tpu/ops/sweep_solver.py:95",
        "launches": grad["launches"],
        "max_abs_err": grad["max_abs_err"],
        "ms": grad["ms"],
        "plain_ms": grad["plain_ms"],
        "bound_ms": grad["bound_ms"],
        "bound_by": grad["bound_by"],
        "library_ms": None,
        "eager_engine_ms": grad["eager_ms"],
        "lindblad_config3": {key: lind[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "eager_ms")},
    }, {
        "name": "member_sweep",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/member_sweep.cu",
        "replaces": "qiskit_dynamics_tpu/ops/member_sweep.py:65",
        **{key: l8[0][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "bound_fp32_ms": l8[0]["bound_fp32_ms"],
        "order1_ms": l8[0]["order1_ms"],
        "blocks_per_sm": l8[0]["blocks_per_sm"],
        "bracket_dominated_err_c128": b3_bracket,
        "eager_engine_ms": l8[0]["eager_ms"],
        "sims_per_s": l8[0]["sims_per_s"],
        "lindblad_dim8_magnus2": {key: l8[1][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_fp32_ms",
            "order1_ms", "hermitian_ms", "eager_ms", "sims_per_s")},
    }, {
        "name": "horner_apply",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/horner_apply.cu",
        "replaces": "qiskit_dynamics_tpu/ops/horner_pallas.py:78",
        **{key: l256[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "order1_ms": l256["order1_ms"],
        "clusters_resident": l256["clusters_resident"],
        "bound_ops_ms": l256["bound_ops_ms"],
        "sims_per_s": l256["sims_per_s"],
        "streaming_variant_ms": l256["streaming_ms"],
        "einsum_route_call_ms": l256["einsum_call_ms"],
        "eager_engine_call_ms": l256["eager_call_ms"],
    }, {
        "name": "chain_apply",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/chain_apply.cu",
        "replaces": "qiskit_dynamics_tpu/ops/chain_apply.py:28",
        **dyson["chain"],
        "library_ms": None,
        "dyson_grad_sims_per_s": dyson["grad_sims_per_s"],
        "dyson_max_err": dyson["max_err"],
        "magnus_row": magnus["chain"],
        "complex128": {**dyson_df["chain"], "dyson_df_sims_per_s": dyson_df["sims_per_s"],
                       "dyson_df_max_err": dyson_df["max_err"],
                       "magnus_df_row": magnus_df["chain"]},
    }, {
        "name": "monomial_contract",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/monomial_contract.cu",
        "replaces": None,
        **dyson["b11"],
        "magnus_row": magnus["b11"],
    }, {
        "name": "expm_taylor_bol",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/batched_linalg.cu",
        "replaces": "qiskit_dynamics_tpu/ops/batched_linalg.py:99",
        **magnus["expm"],
        "magnus_grad_sims_per_s": magnus["grad_sims_per_s"],
        "magnus_max_err": magnus["max_err"],
        "complex128": {**magnus_df["expm"], "magnus_df_sims_per_s": magnus_df["sims_per_s"],
                       "magnus_df_max_err": magnus_df["max_err"]},
    }, {
        "name": "expm_taylor_bol_bwd",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/batched_linalg.cu",
        "replaces": "qiskit_dynamics_tpu/ops/batched_linalg.py:192",
        **magnus["expm_bwd"],
    }, {
        "name": "matmul_bol",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/batched_linalg.cu",
        "replaces": "qiskit_dynamics_tpu/ops/batched_linalg.py:52",
        **magnus["matmul"],
    }, {
        "name": "df_magnus_sweep",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/df_magnus_sweep.cu",
        "replaces": "qiskit_dynamics_tpu/ops/df_sweep_pallas.py:78",
        **{key: df32[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "members_per_sm": df32["members_per_sm"],
        "dmma_sass_count": df32["dmma_sass_count"],
        "df32_sims_per_s": df32["rows"]["df32"]["sims_per_s"],
        "df32_max_err": df32["rows"]["df32"]["max_err"],
        "df32_gauss_sims_per_s": df32["rows"]["df32_gauss"]["sims_per_s"],
        "df32_gauss_max_err": df32["rows"]["df32_gauss"]["max_err"],
        "cheb_sweep_sims_per_s": cheb["sims_per_s"],
        "cheb_nodes": cheb["nodes"],
        "cheb_max_err": cheb["max_err"],
        "cheb2d_sims_per_s": cheb["map_sims_per_s"],
        "cheb2d_nodes": cheb["map_nodes"],
        "cheb2d_max_err": cheb["map_max_err"],
    }, {
        "name": "expm_chain",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/expm_chain.cu",
        "replaces": "qiskit_dynamics_tpu/ops/expm_chain_pallas.py:44",
        **{key: chain[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "pallas_us_per_expm": chain["pallas_us_per_expm"],
        "xla_us_per_expm": chain["xla_us_per_expm"],
        "checksum_rel": chain["checksum_rel"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
