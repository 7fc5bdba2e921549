#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one stdout line each (details of phase 3 go to stderr); any failure
raises and exits non-zero:

1. device: a CUDA device is required; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   reports them.
2. build: compiles the lockstep-adaptive dopri5 kernel
   (``qiskit_dynamics_tpu_torch/csrc/adaptive_sweep.cu``) with nvcc.
3. kernel against its eager twin on the card, in every mode (constant
   envelopes with padded lanes, envelope tables, eval times, budget
   exhaustion, stall guard) at n = 4, 9, 16, 27: final states within 1e-5,
   equal accepted-step counts per tile, step sizes within 1e-5 relative,
   NaN in the same tiles.
4. the main path at full width: ``cr_solver()`` (n = 16) through
   ``Solver.solve_sweep(method="fused_dopri5")`` over 10,000 amplitudes,
   T = 100, atol = rtol = 1e-6, h0 = 0.1; three probe members against the
   port's float64 DOP853 (atol = rtol = 1e-8) within 1e-5 in population;
   the kernel launch counter must rise; sims/s from a steady block of at
   least 1 s and 3 repeats; the kernel's and the twin's time at that shape.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np

SWEEP = 10_000
T_MAIN = 100.0
AMP_SCALE = 0.02
PROBES = 3
MAIN_TOL = 1e-6
MODE_TOL = 1e-3
DIMS = (4, 9, 16, 27)


class CheckFailed(RuntimeError):
    """A phase's result is outside its stated bound."""


def check(ok: bool, message: str):
    if not ok:
        raise CheckFailed(message)


def log(message: str):
    print(message, file=sys.stderr, flush=True)


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


# --------------------------------------------------------------------------
# phase 4 helpers
# --------------------------------------------------------------------------
def steady_time(torch, fn, target_s=1.0, min_repeats=3):
    """Per-call seconds from one block of back-to-back calls lasting at least
    ``target_s`` and ``min_repeats`` calls, synchronized at both ends."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - start
    reps = max(min_repeats, math.ceil(target_s / max(first, 1e-9)))
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    block = time.perf_counter() - start
    return block / reps, block, reps


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

    from qiskit_dynamics_tpu_torch import Signal
    from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
    from qiskit_dynamics_tpu_torch.kernels import _build
    from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw
    from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _expand_lanes, sweep_arguments

    # phase 2: build
    start = time.perf_counter()
    _build.load("adaptive_sweep")
    build_s = time.perf_counter() - start
    report = sorted(_build.BUILD_DIR.glob("libadaptive_sweep_*.so.ptxas.txt"))
    ptxas = " ".join(
        line.strip() for line in (report[-1].read_text().splitlines() if report else [])
        if "registers" in line or "spill" in line
    )
    print(f"phase 2 build: adaptive_sweep.cu built in {build_s:.2f} s; {ptxas}", flush=True)

    # phase 3: kernel against twin, every mode, every n
    start = time.perf_counter()
    state_diff, step_rel = phase_modes(torch, asw, _expand_lanes)
    print(f"phase 3 kernel vs twin: 5 modes x n in {DIMS} agree (max state diff "
          f"{state_diff:.2e} <= 1e-5, max step rel {step_rel:.2e} <= 1e-5) in "
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
    asw.sweep_dopri5_lockstep.launches = 0
    out = sweep()
    torch.cuda.synchronize()
    launches = asw.sweep_dopri5_lockstep.launches
    check(launches > 0, "the main path did not launch the adaptive_sweep kernel")
    pops = (out.abs() ** 2).cpu().numpy()
    check(pops.shape == (SWEEP, dim), f"output shape {pops.shape} != {(SWEEP, dim)}")
    check(bool(np.isfinite(pops).all()), "non-finite populations in the main path")
    norm_dev = float(np.max(np.abs(pops.sum(axis=1) - 1.0)))

    ref_solver, _ = cr_solver()  # float64 on the host
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
    torch.cuda.synchronize()
    start = time.perf_counter()
    twin_out = asw.sweep_dopri5_lockstep_plain(inputs)[0]
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - start) * 1e3
    main_diff = float((kernel_out - twin_out).abs().max())
    check(main_diff <= 1e-5, f"main-path kernel vs twin diff {main_diff:.2e} > 1e-5")
    host_ms = per_call * 1e3 - kernel_ms
    print(
        f"phase 4 main path: cr_solver n={dim}, {SWEEP} members, T={T_MAIN}, tol {MAIN_TOL}: "
        f"{sims_per_s:.1f} sims/s ({reps} calls in a {block_s:.2f} s block, "
        f"{per_call * 1e3:.2f} ms/call = kernel {kernel_ms:.2f} ms + host prep and glue "
        f"{host_ms:.2f} ms); twin {twin_ms:.1f} ms; kernel vs twin {main_diff:.2e}; "
        f"cr_sweep_max_err {max_err:.2e} (<= 1e-5, {PROBES} probes vs DOP853 1e-8 at "
        f"{dop853_s:.2f} s/sim); max |norm - 1| {norm_dev:.2e}; launches {launches}",
        flush=True,
    )

    kernels = [{
        "name": "adaptive_sweep",
        "route": "cuda",
        "source": "qiskit_dynamics_tpu_torch/csrc/adaptive_sweep.cu",
        "replaces": "qiskit_dynamics_tpu/ops/adaptive_sweep.py:67",
        "launches": launches,
        "max_abs_err": main_diff,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
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
