r"""Fused lockstep-adaptive Dormand-Prince sweep: CUDA kernel and eager twin.

Counterpart of ``qiskit_dynamics_tpu/ops/adaptive_sweep.py``. Solves
``y'_b = G_b(t) y_b`` for a sweep of lanes with a SHARED adaptive time grid
per lane tile: a step is accepted when the max error over the tile's lanes
passes the tolerance, so every lane of a tile advances together
("lockstep"). Generators are frame-basis:
``G(t) = P(t) * (static + sum_j c_j(t) ops_j)`` with
``P(t)[i,m] = exp(i omega[i,m] t)`` and ``c_j(t, b) = Re[E_jb(t) e^{i w_j t}]``,
``E`` a constant per-lane amplitude ``(k, B)`` or a piecewise-constant
envelope table ``(k, S, B)`` sampled every ``env_dt``. In table mode steps
are clipped to cell boundaries and every stage of a step reads the cell at
the step midpoint.

Error control: rms over state entries of ``err/scale`` with
``scale = atol + rtol*max(|y|,|y_new|)``, max over lanes; step factor
``clip(0.9 err^(-1/5), 0.2, 10)`` (shrink-only on rejection), a stall guard,
FSAL reuse of the 7th stage. A tile whose step budget runs out before ``tf``
is NaN-poisoned.

Precision: the state and stage arithmetic are float32 (as in the TPU
kernel); elapsed time, step sizes and every phase argument are float64 and
reduced with ``fmod`` before ``cos``/``sin`` (the TPU kernel's f32 (hi, lo)
pairs of ``ops/trig_reduce.py`` are replaced by native FP64).

Two implementations of the same arithmetic:

- ``csrc/adaptive_sweep.cu``: one thread-block cluster per tile (Hopper), a
  member per lane group with its stages in registers (:func:`launch_shape`).
- :func:`sweep_dopri5_lockstep_plain`: eager PyTorch, batched over tiles.

:func:`sweep_dopri5_lockstep` runs the kernel for CUDA tensors and the twin
for CPU tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..unified import default_device, to_tensor
from ..utils import metrics
from .rk_tableaus import (
    DOPRI5_A as _A,
    DOPRI5_B as _B,
    DOPRI5_C as _C,
    DOPRI5_E as _E,
    DOPRI5_N_STAGES as _N_STAGES,
)

__all__ = ["sweep_dopri5_lockstep", "sweep_dopri5_lockstep_plain", "prepare_inputs"]

MAX_N = 64  # the kernel's compiled cap on the state dimension
MAX_SHARED_BYTES = 232448  # dynamic shared memory a block may use on Hopper
_EPS32X4 = 4.0 * 1.1920929e-7  # stall guard: 4 f32 ulps
_TWO_PI = 2.0 * np.pi


@dataclass
class SweepInputs:
    """Kernel-ready inputs: f32 real/imag planes, f64 frequencies and times."""

    statr: torch.Tensor  # (n, n) f32
    stati: torch.Tensor
    opsr: torch.Tensor  # (k, n, n) f32
    opsi: torch.Tensor
    omega: torch.Tensor  # (n, n) f64
    freqs: torch.Tensor  # (k,) f64 angular carriers
    envr: torch.Tensor  # (k, S, B) f32
    envi: torch.Tensor
    y0r: torch.Tensor  # (n, B) f32
    y0i: torch.Tensor
    eval_ts: Optional[torch.Tensor]  # (n_eval,) f64 elapsed times
    t0: float
    dur: float
    env_dt: float
    atol: float
    rtol: float
    max_steps: int
    h0: float
    tile_b: int

    @property
    def n(self) -> int:
        return self.statr.shape[0]

    @property
    def k(self) -> int:
        return self.opsr.shape[0]

    @property
    def n_env(self) -> int:
        return self.envr.shape[1]

    @property
    def n_eval(self) -> int:
        return 0 if self.eval_ts is None else self.eval_ts.shape[0]

    @property
    def batch(self) -> int:
        return self.y0r.shape[1]


def _planes(x, device):
    x = to_tensor(x, device=device)
    if not x.is_complex():
        x = x.to(torch.complex128)
    return torch.real(x).float().contiguous(), torch.imag(x).float().contiguous()


def prepare_inputs(
    static_op, operators, frame_omega, signal_freqs, signal_amps, y0, tf, t0=0.0,
    atol=1e-6, rtol=1e-6, max_steps=4096, h0=1e-2, tile_b=512, env_dt=0.0,
    eval_ts=None,
) -> SweepInputs:
    """Validate the arguments of :func:`sweep_dopri5_lockstep` and convert
    them to kernel-ready planes on the device of ``y0`` (the CUDA device
    when ``y0`` is not a tensor)."""
    device = y0.device if isinstance(y0, torch.Tensor) else default_device()
    statr, stati = _planes(static_op, device)
    opsr, opsi = _planes(operators, device)
    k, n, _ = opsr.shape
    y0r, y0i = _planes(y0, device)
    B = y0r.shape[-1]
    if B % tile_b != 0:
        raise ValueError(f"sweep batch {B} must be a multiple of tile_b={tile_b}")
    amps = to_tensor(signal_amps, device=device)
    if amps.ndim == 2:
        amps = amps[:, None, :]
        env_dt = float(tf - t0)  # any positive value; index is always 0
    elif env_dt <= 0.0:
        raise ValueError("env_dt must be set when passing (k, S, B) envelope tables.")
    envr, envi = _planes(amps, device)

    ts = None
    if eval_ts is not None:
        ts_np = np.asarray(eval_ts, dtype=np.float64)
        if ts_np.ndim != 1 or ts_np.size == 0:
            raise ValueError("eval_ts must be a non-empty 1d tuple of times.")
        if np.any(ts_np <= 0) or np.any(ts_np > (tf - t0) * (1 + 1e-9)):
            raise ValueError("eval_ts must lie in (0, tf - t0].")
        if ts_np.size > 1 and np.any(np.diff(ts_np) <= 0):
            raise ValueError("eval_ts must be strictly increasing.")
        ts = torch.as_tensor(ts_np, device=device)

    f64 = dict(dtype=torch.float64, device=device)
    return SweepInputs(
        statr=statr, stati=stati, opsr=opsr, opsi=opsi,
        omega=to_tensor(frame_omega, **f64).reshape(n, n).contiguous(),
        freqs=to_tensor(signal_freqs, **f64).reshape(k).contiguous(),
        envr=envr, envi=envi, y0r=y0r, y0i=y0i, eval_ts=ts,
        t0=float(t0), dur=float(tf) - float(t0), env_dt=float(env_dt),
        atol=float(atol), rtol=float(rtol), max_steps=int(max_steps), h0=float(h0),
        tile_b=int(tile_b),
    )


def sweep_dopri5_lockstep(
    static_op, operators, frame_omega, signal_freqs, signal_amps, y0, tf, t0=0.0,
    atol=1e-6, rtol=1e-6, max_steps=4096, h0=1e-2, tile_b=512, env_dt=0.0,
    eval_ts=None, record_steps=False,
):
    r"""Lockstep-adaptive dopri5 sweep over ``[t0, tf]``.

    Runs the CUDA kernel when ``y0`` is a CUDA tensor (and raises if it
    cannot), and the eager twin when ``y0`` lies on the CPU. The other
    arguments are moved to the device of ``y0``.

    Args:
        static_op: (n, n) complex static generator (frame basis, diag removed).
        operators: (k, n, n) complex signal operators (frame basis).
        frame_omega: (n, n) real frame frequency-difference matrix.
        signal_freqs: (k,) real angular carrier frequencies (``2 pi nu_j``).
        signal_amps: per-lane complex envelopes, (k, B) constant or (k, S, B)
            piecewise-constant over cells of width ``env_dt``.
        y0: (n, B) complex initial states (frame basis).
        tf: final time; integration runs over [t0, tf]. Envelope tables
            cover [t0, tf] and are indexed by elapsed time.
        atol/rtol: tolerances (error controlled at the worst lane per tile).
        max_steps: step budget per tile; exhausted -> NaN output for the tile.
        h0: initial step size.
        tile_b: lanes per tile (B must be a multiple).
        env_dt: envelope cell width (required when signal_amps is 3d).
        eval_ts: optional strictly increasing ELAPSED trajectory times in
            ``(0, tf - t0]``: steps clip to them and the state at each is
            stored.
        record_steps: also return each tile's accepted step sizes as an
            (n_tiles, max_steps) float64 tensor (zero-padded).

    Returns:
        (n, B) complex64 final states (frame basis); with ``eval_ts`` a tuple
        ``(final, trajectory)``, ``trajectory`` (len(eval_ts), n, B); with
        ``record_steps`` the result is wrapped as ``(result, step_record)``.
    """
    with metrics.span("sweep.prepare"):
        inputs = prepare_inputs(
            static_op, operators, frame_omega, signal_freqs, signal_amps, y0, tf, t0=t0,
            atol=atol, rtol=rtol, max_steps=max_steps, h0=h0, tile_b=tile_b,
            env_dt=env_dt, eval_ts=eval_ts,
        )
    with metrics.span("sweep.engine", tile_b=inputs.tile_b, lanes=inputs.batch):
        if inputs.y0r.is_cuda:
            final, traj, rec = _launch_kernel(inputs, record_steps)
        elif inputs.y0r.device.type == "cpu":
            final, traj, rec = sweep_dopri5_lockstep_plain(inputs, record_steps)
        else:
            raise RuntimeError(
                f"sweep_dopri5_lockstep has no path for device {inputs.y0r.device}.")
    result = final if traj is None else (final, traj)
    return (result, rec) if record_steps else result


# the number of times the CUDA kernel was launched (reset by callers that count)
sweep_dopri5_lockstep.launches = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
# Threads per block of the kernel's instantiations by rows per lane (their
# __launch_bounds__: 64 registers a thread at 1,024, 128 at 512)
MAX_THREADS = {1: 1024, 2: 1024, 4: 512}
# blocks per tile; 16 is the card's non-portable cluster size
CLUSTER_SIZES = (1, 2, 4, 8, 16)
STAGES = 6  # new RHS stages per step, whose tables a block forms per pass
# shared memory a block keeps within, where it can, so that two share an SM
SHARED_TARGET_BYTES = MAX_SHARED_BYTES // 2
_ERR_RESIDENT = 1002  # the launch's code for a shape the card co-schedules no cluster of
CONTROL_BYTES = 304  # the kernel's per-block control block (sizeof, padded to 16)

# the counters the kernel adds each tile's steps into, while metrics record
STEP_COUNTERS = ("b1.steps_attempted", "b1.steps_accepted")

_PTR = ctypes.c_void_p
_ARGTYPES = (
    [_PTR] * 20
    + [ctypes.c_int] * 8
    + [ctypes.c_double] * 6
    + [ctypes.c_int] * 6
    + [_PTR]
)


@dataclass(frozen=True)
class LaunchShape:
    """How the kernel lays a tile over the card: a cluster of ``cluster``
    blocks of ``threads`` threads; a member is ``lanes`` lanes of one warp,
    each owning ``rows`` rows; a lane group runs ``members_per_group``
    members one after the other (1: the state stays in registers for the
    whole call); the block forms ``stages_per_pass`` stages' tables at once
    in ``smem_bytes`` of shared memory."""

    cluster: int
    lanes: int
    rows: int
    threads: int
    members_per_group: int
    stages_per_pass: int
    smem_bytes: int


def shared_bytes(n: int, k: int, stages: int, threads: int, lanes: int) -> int:
    """Dynamic shared memory of one block (the layout in the source): the
    control block, the complex tables and carrier phases of ``stages``
    stages, the per-group coefficients of the any-k instantiation, 32 warp
    maxima, the exchange."""
    groups = threads // lanes
    return (CONTROL_BYTES + 8 * stages * ((k + 1) * n * n + k)
            + 4 * ((0 if k == 2 else groups * k) + 32 + 32))


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def candidate_shapes(n: int, k: int, tile_b: int):
    """Every launch shape that keeps each member's state in registers (one
    member per lane group): G in ``CLUSTER_SIZES`` dividing ``tile_b``, R in
    (1, 2, 4) rows per lane with P = the power of two at least n / R (at most
    32; no empty row block)."""
    shapes = []
    for rows in MAX_THREADS:
        lanes = _pow2_at_least(-(-n // rows))
        if lanes > 32 or lanes * (rows - 1) >= n:
            continue
        for cluster in CLUSTER_SIZES:
            if tile_b % cluster:
                continue
            threads = tile_b // cluster * lanes
            if threads <= MAX_THREADS[rows]:
                shapes.append(_with_tables(n, k, cluster, lanes, rows, threads, 1))
    return shapes


def _with_tables(n, k, cluster, lanes, rows, threads, per_group) -> LaunchShape:
    """The shape with the most stages per table pass that fits: within
    ``SHARED_TARGET_BYTES`` where one stage does, else within
    ``MAX_SHARED_BYTES``."""
    for limit in (SHARED_TARGET_BYTES, MAX_SHARED_BYTES):
        for stages in (6, 3, 2, 1):
            smem = shared_bytes(n, k, stages, threads, lanes)
            if smem <= limit:
                return LaunchShape(cluster, lanes, rows, threads, per_group, stages, smem)
    raise ValueError(
        f"the frame-rotated operator tables of one stage need "
        f"{shared_bytes(n, k, 1, threads, lanes)} bytes of shared memory (n={n}, k={k}); a "
        f"block may use {MAX_SHARED_BYTES}."
    )


def shape_for(n: int, k: int, tile_b: int, cluster: int) -> LaunchShape:
    """The launch shape at clusters of ``cluster`` blocks (a divisor of
    ``tile_b``) with the fewest rows per lane that leave P <= 32: one member
    per lane group where the block holds them, else as few lane groups per
    block as divide the members, each running several members from a
    scratch buffer."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the CUDA sweep kernel takes n <= {MAX_N}; got n={n}.")
    if cluster not in CLUSTER_SIZES or tile_b % cluster:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES} dividing tile_b={tile_b}.")
    rows = next(r for r in MAX_THREADS if _pow2_at_least(-(-n // r)) <= 32)
    lanes = _pow2_at_least(-(-n // rows))
    members = tile_b // cluster
    groups = max(g for g in range(1, MAX_THREADS[rows] // lanes + 1) if members % g == 0)
    return _with_tables(n, k, cluster, lanes, rows, groups * lanes, members // groups)


def launch_shape(n: int, k: int, tile_b: int) -> LaunchShape:
    """The kernel's launch shape for state dimension ``n``, ``k`` operators
    and tiles of ``tile_b`` members (pure; the card is not asked).

    Among :func:`candidate_shapes` (clusters of 16 included: Hopper takes
    them with the non-portable attribute), the largest cluster, which spreads
    a tile over the most SMs; at that cluster the block nearest 256 threads
    (the fewer rows on a tie). At the main row (n = 16, tile_b = 512) that is
    16 blocks of 256 threads, 8 lanes of 2 rows per member: the fastest shape
    measured there (``scripts/torch_adaptive_sweep_time.py``). Where no shape
    keeps a member in registers (a tile too large for a cluster of 16
    blocks), :func:`shape_for` at the largest cluster dividing ``tile_b``."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the CUDA sweep kernel takes n <= {MAX_N}; got n={n}.")
    shapes = candidate_shapes(n, k, tile_b)
    if shapes:
        return max(shapes, key=lambda s: (s.cluster, -abs(s.threads.bit_length() - 9), -s.rows))
    return shape_for(n, k, tile_b, max(g for g in CLUSTER_SIZES if tile_b % g == 0))


def _kernel_lib():
    from ..kernels import _build

    lib = _build.load("adaptive_sweep")
    lib.adaptive_sweep_launch.argtypes = _ARGTYPES
    lib.adaptive_sweep_launch.restype = ctypes.c_int
    lib.adaptive_sweep_active_clusters.argtypes = [ctypes.c_int] * 9
    lib.adaptive_sweep_active_clusters.restype = ctypes.c_int
    lib.adaptive_sweep_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.adaptive_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.adaptive_sweep_error_string.argtypes = [ctypes.c_int]
    lib.adaptive_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _shape_args(shape: LaunchShape):
    return (shape.cluster, shape.lanes, shape.rows, shape.threads, shape.members_per_group,
            shape.stages_per_pass)


def active_clusters(n: int, k: int, tile_b: int, shape: Optional[LaunchShape] = None) -> int:
    """Clusters of the launch shape (by default :func:`launch_shape`'s) that
    the card co-schedules, by the CUDA occupancy calculator."""
    shape = launch_shape(n, k, tile_b) if shape is None else shape
    lib = _kernel_lib()
    count = lib.adaptive_sweep_active_clusters(n, k, tile_b, *_shape_args(shape))
    if count < 0:
        raise RuntimeError(
            f"adaptive_sweep occupancy query for {shape}: "
            f"{lib.adaptive_sweep_error_string(-count).decode()}"
        )
    return count


def _launch_kernel(inputs: SweepInputs, record_steps: bool, shape: Optional[LaunchShape] = None,
                   steps_out: Optional[torch.Tensor] = None,
                   clocks: Optional[torch.Tensor] = None):
    """Launch the kernel at :func:`launch_shape`'s shape, or at ``shape``
    (the card tests and the timing script force one). ``steps_out``, an
    int32 tensor of one entry per tile, receives the steps each tile took
    (rejected ones included); ``clocks``, an int64 (blocks, 4) tensor, the
    cycles thread 0 of each block spent forming tables, in the stages, in
    the exchange and in the control. While metrics record, every tile adds
    its attempted and accepted steps to :data:`STEP_COUNTERS`
    (:func:`~qiskit_dynamics_tpu_torch.utils.metrics.device_counters`)."""
    n, k, B, tile_b = inputs.n, inputs.k, inputs.batch, inputs.tile_b
    if shape is None:
        shape = launch_shape(n, k, tile_b)
    elif n > MAX_N:
        raise ValueError(f"the CUDA sweep kernel takes n <= {MAX_N}; got n={n}.")
    device = inputs.y0r.device
    n_tiles = B // tile_b
    n_eval = inputs.n_eval
    outr = torch.empty((n, B), dtype=torch.float32, device=device)
    outi = torch.empty_like(outr)
    evalr = torch.zeros((n_eval, n, B), dtype=torch.float32, device=device)
    evali = torch.zeros_like(evalr)
    rec = torch.zeros((n_tiles, inputs.max_steps), dtype=torch.float64, device=device)
    scratch = None
    if shape.members_per_group > 1:
        scratch = torch.empty(
            (n_tiles * shape.cluster, shape.members_per_group, 9, shape.rows, shape.threads, 2),
            dtype=torch.float32, device=device,
        )

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    lib = _kernel_lib()
    step_counts = metrics.device_counters(STEP_COUNTERS, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.adaptive_sweep_launch(
            ptr(inputs.statr), ptr(inputs.stati), ptr(inputs.opsr), ptr(inputs.opsi),
            ptr(inputs.omega), ptr(inputs.freqs), ptr(inputs.envr), ptr(inputs.envi),
            ptr(inputs.eval_ts), ptr(inputs.y0r), ptr(inputs.y0i), ptr(outr), ptr(outi),
            ptr(evalr), ptr(evali), ptr(rec) if record_steps else None, ptr(scratch),
            ptr(steps_out), ptr(clocks), ptr(step_counts), n, k, inputs.n_env, n_eval, B,
            tile_b, inputs.max_steps, int(record_steps),
            inputs.t0, inputs.dur, inputs.env_dt, inputs.atol, inputs.rtol, inputs.h0,
            *_shape_args(shape), stream,
        )
    if code == _ERR_RESIDENT:
        raise RuntimeError(f"the card co-schedules no cluster of the adaptive_sweep shape {shape}.")
    if code != 0:
        raise RuntimeError(
            f"adaptive_sweep kernel launch at {shape} failed: "
            f"{lib.adaptive_sweep_error_string(code).decode()}"
        )
    sweep_dopri5_lockstep.launches += 1
    final = torch.complex(outr, outi)
    traj = torch.complex(evalr, evali) if n_eval else None
    return final, traj, rec if record_steps else None


# ---------------------------------------------------------------------------
# Eager twin: the kernel's arithmetic, batched over tiles
# ---------------------------------------------------------------------------
# The twin works on float32 real/imag planes and performs the kernel's
# operations in the kernel's order (the kernel is built without FMA
# contraction), so on the card the two agree to the last bit wherever the
# transcendental functions do.
def _trig(x: torch.Tensor):
    """(cos, sin) of a float64 phase argument, reduced, rounded to float32."""
    x = torch.fmod(x, _TWO_PI)
    return torch.cos(x).float(), torch.sin(x).float()


def sweep_dopri5_lockstep_plain(inputs: SweepInputs, record_steps: bool = False):
    """The eager twin on any device: ``(final, trajectory or None, record or None)``."""
    n, k, B, tile_b = inputs.n, inputs.k, inputs.batch, inputs.tile_b
    n_env, n_eval, max_steps = inputs.n_env, inputs.n_eval, inputs.max_steps
    device = inputs.y0r.device
    T = B // tile_b
    tiles = torch.arange(T, device=device)
    atol, rtol = float(np.float32(inputs.atol)), float(np.float32(inputs.rtol))
    # envelopes per tile: (k, S, T, L)
    envr = inputs.envr.reshape(k, n_env, T, tile_b)
    envi = inputs.envi.reshape(k, n_env, T, tile_b)

    def lanes(x):  # (n, B) -> (T, n, L)
        return x.reshape(x.shape[0], T, tile_b).transpose(0, 1)

    def rhs(te, cell, wr, wi):
        """G(t0 + te) w per tile: te (T,) f64, cell (T,) long, w planes (T, n, L)."""
        ta = inputs.t0 + te
        c, s = _trig(inputs.omega[None] * ta[:, None, None])  # (T, n, n) frame phases
        cw, sw = _trig(inputs.freqs[None] * ta[:, None])  # (T, k) carrier phases
        er = envr[:, cell, tiles].transpose(0, 1)  # (T, k, L)
        ei = envi[:, cell, tiles].transpose(0, 1)
        coef = er * cw[..., None] - ei * sw[..., None]  # (T, k, L)
        # per lane g = P o S + sum_j c_j P o O_j: (T, n, n, L) planes
        gr = (inputs.statr * c - inputs.stati * s)[..., None]
        gi = (inputs.statr * s + inputs.stati * c)[..., None]
        for j in range(k):
            cj = coef[:, j, None, None, :]
            gr = gr + cj * (inputs.opsr[j] * c - inputs.opsi[j] * s)[..., None]
            gi = gi + cj * (inputs.opsr[j] * s + inputs.opsi[j] * c)[..., None]
        accr = torch.zeros_like(wr)
        acci = torch.zeros_like(wi)
        for m in range(n):
            xr, xi = wr[:, m, None, :], wi[:, m, None, :]
            accr = accr + (gr[:, :, m] * xr - gi[:, :, m] * xi)
            acci = acci + (gr[:, :, m] * xi + gi[:, :, m] * xr)
        return accr, acci

    def combine(coefs, h, stages):
        """y + sum_q (f32)(h coef_q) k_q over the nonzero tableau entries."""
        wr, wi = yr.clone(), yi.clone()
        for q, a in enumerate(coefs):
            if a != 0.0:
                cq = (h * float(a)).float()[:, None, None]
                wr = wr + cq * stages[q][0]
                wi = wi + cq * stages[q][1]
        return wr, wi

    yr, yi = lanes(inputs.y0r), lanes(inputs.y0i)  # (T, n, L) f32
    stages = [None] * (_N_STAGES + 1)
    zeros_t = torch.zeros(T, dtype=torch.float64, device=device)
    cell0 = torch.zeros(T, dtype=torch.long, device=device)
    stages[0] = rhs(zeros_t, cell0, yr, yi)

    s = zeros_t.clone()
    h_prop = torch.full((T,), inputs.h0, dtype=torch.float64, device=device)
    steps = torch.zeros(T, dtype=torch.long, device=device)
    bad = torch.zeros(T, dtype=torch.bool, device=device)
    eidx = torch.zeros(T, dtype=torch.long, device=device)
    aidx = torch.zeros(T, dtype=torch.long, device=device)
    rec = torch.zeros((T, max_steps), dtype=torch.float64, device=device)
    traj = torch.zeros((2, max(n_eval, 1), T, n, tile_b), dtype=torch.float32, device=device)
    inv_env_dt = 1.0 / inputs.env_dt

    def cell_of(x):
        return torch.nan_to_num(x, nan=0.0).clamp(0, n_env - 1).long()

    while True:
        active = ((inputs.dur - s) > 0.0) & (steps < max_steps)
        if not bool(active.any()):
            break
        h = torch.minimum(h_prop, inputs.dur - s)
        target = zeros_t
        have_target = eidx < n_eval
        if n_eval > 0:
            target = inputs.eval_ts[eidx.clamp(max=n_eval - 1)]
            h = torch.where(have_target, torch.minimum(h, (target - s).clamp(min=0.0)), h)
        step_cell = cell0
        if n_env > 1:
            cell_f = torch.floor(s * inv_env_dt + 1e-4)
            h = torch.minimum(h, (cell_f + 1.0) * inputs.env_dt - s)
            step_cell = cell_of((s + 0.5 * h) * inv_env_dt)

        for st in range(1, _N_STAGES):
            wr, wi = combine(_A[st, :st], h, stages)
            stages[st] = rhs(s + float(_C[st]) * h, step_cell, wr, wi)
        wr, wi = combine(_B, h, stages)
        stages[6] = rhs(s + h, step_cell, wr, wi)

        er = torch.zeros_like(yr)
        ei = torch.zeros_like(yi)
        for q in range(_N_STAGES + 1):
            if _E[q] != 0.0:
                cq = (h * float(_E[q])).float()[:, None, None]
                er = er + cq * stages[q][0]
                ei = ei + cq * stages[q][1]
        ay = torch.sqrt(yr * yr + yi * yi)
        aw = torch.sqrt(wr * wr + wi * wi)
        scale = atol + rtol * torch.fmax(ay, aw)
        err_sq = (er * er + ei * ei) / (scale * scale)  # (T, n, L)
        err_sq_sum = err_sq[:, 0]
        for i in range(1, n):
            err_sq_sum = err_sq_sum + err_sq[:, i]
        # rms over the state, max over the tile; divide by a tensor, not the
        # scalar n (a CUDA tensor/scalar division multiplies by 1/n)
        err_max = torch.amax(err_sq_sum, dim=1)
        err_norm = torch.sqrt(err_max / torch.full_like(err_max, float(n)))  # (T,) f32

        stalled = h <= _EPS32X4 * torch.clamp(s, min=1.0)
        accept = ((err_norm <= 1.0) | stalled) & active
        bad = bad | (active & stalled & (err_norm > 1.0) & (err_norm > 100.0))
        sel = accept[:, None, None]
        yr, yi = torch.where(sel, wr, yr), torch.where(sel, wi, yi)
        stages[0] = tuple(torch.where(sel, new, old) for new, old in zip(stages[6], stages[0]))
        if record_steps:
            slot = aidx.clamp(max=max_steps - 1)  # finished tiles may sit at max_steps
            rec[tiles, slot] = torch.where(accept, h, rec[tiles, slot])
        aidx = aidx + accept.long()
        s_new = torch.where(accept, s + h, s)

        if n_env > 1:
            # FSAL after a cell crossing: stage 0 with the new cell (w == y_new)
            new_cell = cell_of(torch.floor(s_new * inv_env_dt + 1e-4))
            crossed = accept & (new_cell != step_cell) & ((inputs.dur - s_new) > 0.0)
            if bool(crossed.any()):
                fresh = rhs(s_new, new_cell, wr, wi)
                sel = crossed[:, None, None]
                stages[0] = tuple(torch.where(sel, new, old) for new, old in zip(fresh, stages[0]))
        if n_eval > 0:
            eps = _EPS32X4 * torch.clamp(target, min=1.0)
            reached = (have_target & accept & (s_new >= target - eps))[:, None, None]
            slot = eidx.clamp(max=n_eval - 1)
            for part, value in enumerate((yr, yi)):
                traj[part, slot, tiles] = torch.where(reached, value, traj[part, slot, tiles])
            eidx = eidx + reached[:, 0, 0].long()

        safe_err = torch.clamp(err_norm.double(), min=1e-10)
        factor = torch.clamp(0.9 * torch.exp(-0.2 * torch.log(safe_err)), 0.2, 10.0)
        factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
        h_new = h * factor
        if n_env > 1 or n_eval > 0:
            # a boundary-clipped accepted step keeps at least the pre-clip proposal
            h_new = torch.where(accept & (h < h_prop), torch.maximum(h_prop, h_new), h_new)
        h_prop = torch.where(active, h_new, h_prop)
        s = s_new
        steps = steps + active.long()

    if metrics.recording():
        for name, per_tile in zip(STEP_COUNTERS, (steps, aidx)):
            metrics.count(name, int(per_tile.sum()))
    ok = ((inputs.dur - s) <= 0.0) & ~bad & (eidx >= n_eval)
    poison = torch.where(ok, 1.0, float("nan")).float()[:, None, None]

    def unlanes(x):  # (T, n, L) -> (n, B)
        return x.transpose(0, 1).reshape(x.shape[1], B)

    final = torch.complex(unlanes(yr * poison), unlanes(yi * poison))
    trajectory = None
    if n_eval > 0:
        traj = (traj * poison).transpose(2, 3).reshape(2, n_eval, n, B)
        trajectory = torch.complex(traj[0], traj[1])
    return final, trajectory, rec if record_steps else None
