r"""Fixed-step Magnus-2 sweep: CUDA kernel and plain version.

Counterpart of ``qiskit_dynamics_tpu/ops/sweep_solver.py``. Solves
``y'_b = G_b(t) y_b`` for every sweep member ``b`` with T fixed steps of
Magnus-2, where ``G_b(t) = P(t) o (S + sum_j c_{b,j}(t) O_j)`` and
``P(t)[i,m] = exp(i omega[i,m] t)`` is the frame phase matrix. Per step the
generator is sampled at the two Gauss points, combined as
``M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1]``, and applied to the state by a
Horner Taylor action ``y <- sum_{j <= order} M^j y / j!``; the propagator is
never formed.

Two implementations of the same arithmetic:

- ``csrc/sweep_magnus2.cu``: the kernel for Hopper, float32, a member per
  lane group of one warp with register-blocked products and fused
  multiply-adds.
- :func:`sweep_expm_magnus2_plain`: eager PyTorch on any device, batched over
  members, in the real dtype it is given (float32 like the kernel, or
  float64). It performs the same float operations one at a time, so it
  agrees with the kernel to float32 roundoff, not bit for bit.

Both read the frame phases from one table, :func:`phase_table`, formed once
per call on the device from float64 times and frequencies.

:func:`sweep_expm_magnus2` runs the kernel for CUDA tensors (and raises if it
cannot) and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..unified import default_device, to_tensor
from ..utils.metrics import span

__all__ = ["sweep_expm_magnus2", "sweep_expm_magnus2_plain", "prepare_inputs", "phase_table"]

_GAUSS_C1 = 0.5 - np.sqrt(3) / 6
_GAUSS_C2 = 0.5 + np.sqrt(3) / 6
_P2 = np.sqrt(3) / 12

# 3-point Gauss-Legendre nodes + Magnus order-3 (6th-order) combination
# coefficients (Blanes et al. 2009), used by the eager engine
_GAUSS3_D1 = 0.5 - np.sqrt(15) / 10
_GAUSS3_D2 = 0.5
_GAUSS3_D3 = 0.5 + np.sqrt(15) / 10
_M3_C0 = np.sqrt(15) / 3
_M3_C1 = 10.0 / 3



def gauss_nodes(magnus_order: int):
    """The Gauss-Legendre nodes in (0, 1) of the Magnus rule of this order."""
    if magnus_order == 2:
        return (_GAUSS_C1, _GAUSS_C2)
    return (_GAUSS3_D1, _GAUSS3_D2, _GAUSS3_D3)


MAX_N = 32  # the kernel's cap on the state dimension
MAX_SHARED_BYTES = 232448  # dynamic shared memory a block may use on Hopper
_MODES = ("matrix", "matrix_herm", "matvec")
_TWO_PI = 2.0 * np.pi


def _validate_eval_slots(eval_slots, T: int) -> int:
    """Validate a trajectory slot table; returns ``n_eval``.

    The non-negative entries must be exactly a permutation of
    ``range(n_eval)``: a duplicate or gapped slot would leave trajectory
    slots unwritten.
    """
    if len(eval_slots) != T:
        raise ValueError(f"eval_slots must have length T={T}")
    marked = sorted(int(s) for s in eval_slots if int(s) >= 0)
    if not marked:
        raise ValueError("eval_slots must mark at least one step")
    if marked != list(range(len(marked))):
        raise ValueError(
            "the non-negative eval_slots values must be exactly a "
            f"permutation of range(n_eval); got {marked}."
        )
    return len(marked)


def select_mode(mode: str, n: int, order: int, hermitian: bool) -> str:
    """Resolve ``mode="auto"`` with the matmul cost model (per-step cost in
    ``n^2 B`` units: the matrix modes pay the commutator, ``n`` or ``2n``,
    plus ``order`` mat-vecs; matvec mode pays ``4 order``) and validate."""
    if mode == "auto":
        mat_cost = (n if hermitian else 2 * n) + order
        mode = "matvec" if 4 * order < mat_cost else ("matrix_herm" if hermitian else "matrix")
    if mode == "matrix_herm" and not hermitian:
        raise ValueError('mode="matrix_herm" requires hermitian=True')
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return mode


@dataclass
class SweepInputs:
    """Kernel-ready inputs: real/imag planes in one real dtype, the frame
    phases as a :func:`phase_table` in that dtype."""

    statr: torch.Tensor  # (n, n)
    stati: torch.Tensor
    opsr: torch.Tensor  # (k, n, n)
    opsi: torch.Tensor
    omega: torch.Tensor  # (n, n) float64
    phases: torch.Tensor  # (T, 2, columns(n) / 2, n, 4), see phase_table
    coef: torch.Tensor  # (T, 2, k, B)
    y0r: torch.Tensor  # (n, B)
    y0i: torch.Tensor
    slots: Optional[torch.Tensor]  # (T,) int32 step -> trajectory slot, or None
    n_eval: int
    dt: float
    t0: float
    order: int
    mode: str

    @property
    def n(self) -> int:
        return self.statr.shape[0]

    @property
    def k(self) -> int:
        return self.opsr.shape[0]

    @property
    def steps(self) -> int:
        return self.coef.shape[0]

    @property
    def batch(self) -> int:
        return self.y0r.shape[1]

    @property
    def real(self) -> torch.dtype:
        return self.coef.dtype


def prepare_inputs(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, order=8, tile_b=512,
    hermitian=False, mode="auto", eval_slots=None,
) -> SweepInputs:
    """Validate the arguments of :func:`sweep_expm_magnus2` and convert them
    to planes on the device of ``y0`` (the CUDA device when ``y0`` is not a
    tensor), in the real dtype of ``coefficients`` (float64 stays float64,
    anything else is float32). The planes are detached: this function and
    :func:`sweep_expm_magnus2` are not differentiable
    (:func:`~qiskit_dynamics_tpu_torch.ops.sweep_ad.sweep_expm_magnus2_ad` is)."""
    device = y0.device if isinstance(y0, torch.Tensor) else default_device()
    coef = to_tensor(coefficients, device=device).detach()
    real = torch.float64 if coef.dtype == torch.float64 else torch.float32
    coef = coef.to(real).contiguous()
    if coef.ndim != 4 or coef.shape[1] != 2:
        raise ValueError(f"coefficients must be (T, 2, k, B); got {tuple(coef.shape)}")
    T, _, k, B = coef.shape
    if B % tile_b != 0:
        raise ValueError(f"sweep batch {B} must be a multiple of tile_b={tile_b}")

    def planes(x):
        x = to_tensor(x, device=device).detach()
        if not x.is_complex():
            x = x.to(torch.complex128)
        return torch.real(x).to(real).contiguous(), torch.imag(x).to(real).contiguous()

    statr, stati = planes(static_op)
    opsr, opsi = planes(operators)
    y0r, y0i = planes(y0)
    n = y0r.shape[0]
    if y0r.shape != (n, B) or statr.shape != (n, n) or opsr.shape != (k, n, n):
        raise ValueError(
            f"shape mismatch: y0 {tuple(y0r.shape)}, static {tuple(statr.shape)}, operators "
            f"{tuple(opsr.shape)}, coefficients {tuple(coef.shape)}"
        )
    slots, n_eval = None, 0
    if eval_slots is not None:
        n_eval = _validate_eval_slots(eval_slots, T)
        slots = torch.as_tensor(np.asarray(eval_slots, dtype=np.int32), device=device)
    omega = to_tensor(frame_omega, dtype=torch.float64, device=device).reshape(n, n).contiguous()
    return SweepInputs(
        statr=statr, stati=stati, opsr=opsr, opsi=opsi, omega=omega,
        phases=phase_table(omega, float(t0), float(dt), T, real), coef=coef, y0r=y0r, y0i=y0i,
        slots=slots, n_eval=n_eval, dt=float(dt), t0=float(t0), order=int(order),
        mode=select_mode(mode, n, int(order), hermitian),
    )


def columns(n: int) -> int:
    """The kernel's padded state dimension: n rounded up to a multiple of 4."""
    return max(4, -(-n // 4) * 4)


def phase_table(omega: torch.Tensor, t0: float, dt: float, steps: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The frame phases of every step at both Gauss points, formed once per call.

    ``cos`` and ``sin`` of ``fmod(omega * tau, 2 pi)`` with
    ``tau = t0 + (s + c_g) dt``, computed in float64 and rounded to
    ``dtype``, laid out ``(T, 2, columns(n) / 2, n, 4)``: for each pair of
    columns ``(2p, 2p + 1)`` the rows are contiguous, each holding
    ``(cos, sin)`` of both columns (zero past column n). The kernel reads a
    row's pair with one 16-byte load; :func:`phase_matrices` gives the plain
    version the same values as (T, 2, n, n) matrices.
    """
    n = omega.shape[0]
    f64 = dict(dtype=torch.float64, device=omega.device)
    gauss = torch.tensor([_GAUSS_C1, _GAUSS_C2], **f64)
    tau = t0 + (torch.arange(steps, **f64)[:, None] + gauss) * dt  # (T, 2)
    ph = torch.fmod(omega * tau[:, :, None, None], _TWO_PI)  # (T, 2, n, n)
    table = torch.zeros((steps, 2, n, columns(n), 2), dtype=dtype, device=omega.device)
    table[:, :, :, :n, 0] = torch.cos(ph)
    table[:, :, :, :n, 1] = torch.sin(ph)
    return table.reshape(steps, 2, n, -1, 4).transpose(2, 3).contiguous()


def phase_matrices(table: torch.Tensor, n: int):
    """``(cos, sin)``, each (T, 2, n, n), from a :func:`phase_table`."""
    steps = table.shape[0]
    t = table.transpose(2, 3).reshape(steps, 2, n, -1, 2)[:, :, :, :n]
    return t[..., 0], t[..., 1]


def sweep_expm_magnus2(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, order=8, tile_b=512,
    hermitian=False, mode="auto", eval_slots=None,
):
    r"""Fixed-step Magnus-2 sweep solve.

    Runs the CUDA kernel when ``y0`` is a CUDA tensor (float32 only; it
    raises for anything it cannot launch) and the plain version when ``y0``
    lies on the CPU. The other arguments are moved to the device of ``y0``.

    Args:
        static_op: (n, n) complex static generator in the frame basis (frame
            diagonal already subtracted).
        operators: (k, n, n) complex signal operators in the frame basis.
        frame_omega: (n, n) real frequency-difference matrix
            ``Im(d_m) - Im(d_i)`` of the frame diagonal.
        coefficients: (T, 2, k, B) real signal values at the two Gauss points
            of every step, sampled at ``t0 + (step + c_g) dt``. Its dtype
            sets the arithmetic: float64 runs the plain version in float64
            (CPU only), anything else float32.
        y0: (n, B) complex initial states in the frame basis.
        dt: step size; ``T`` steps are taken.
        t0: initial time (frame phases use absolute time).
        order: Taylor order of the expm action.
        tile_b: lane-tile size (B must be a multiple), kept for the JAX
            package's contract; the kernel sizes its blocks itself.
        hermitian: the generators are anti-Hermitian (``G = -iH``); enables
            ``mode="matrix_herm"``. The caller must guarantee it.
        mode: ``"matrix"``, ``"matrix_herm"``, ``"matvec"`` or ``"auto"``
            (the matmul cost model); the same polynomial, rounded differently.
        eval_slots: optional length-T tuple: after step ``s`` the state is
            stored into trajectory slot ``eval_slots[s]`` if ``>= 0``.

    Returns:
        (n, B) complex final states in the frame basis at ``t0 + T dt``;
        with ``eval_slots``, ``(final, trajectory)``, trajectory
        (n_eval, n, B).
    """
    with span("sweep.prepare"):
        inputs = prepare_inputs(
            static_op, operators, frame_omega, coefficients, y0, dt, t0=t0, order=order,
            tile_b=tile_b, hermitian=hermitian, mode=mode, eval_slots=eval_slots,
        )
    with span("sweep.engine"):
        if inputs.y0r.is_cuda:
            final, traj = _launch_kernel(inputs)
        elif inputs.y0r.device.type == "cpu":
            final, traj = sweep_expm_magnus2_plain(inputs)
        else:
            raise RuntimeError(f"sweep_expm_magnus2 has no path for device {inputs.y0r.device}.")
    return final if traj is None else (final, traj)


# the number of times the CUDA kernel was launched (reset by callers that count)
sweep_expm_magnus2.launches = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR] * 13 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [_PTR]


def _kernel_lib(defines: tuple = ()):
    """The kernel library (``defines`` build a variant of the same source for
    experiments; the package passes none)."""
    from ..kernels import _build

    lib = _build.load("sweep_magnus2", defines)
    lib.sweep_magnus2_launch.argtypes = _ARGTYPES
    lib.sweep_magnus2_launch.restype = ctypes.c_int
    lib.sweep_magnus2_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sweep_magnus2_smem_bytes.restype = ctypes.c_size_t
    lib.sweep_magnus2_shape.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.sweep_magnus2_shape.restype = ctypes.c_int
    lib.sweep_magnus2_error_string.argtypes = [ctypes.c_int]
    lib.sweep_magnus2_error_string.restype = ctypes.c_char_p
    return lib


MAX_WARPS_PER_BLOCK = 8
# warps resident per SM past which a wave's time grows with its warps (FP32
# issue and shared loads saturate; the CR shape's block sizes on the card)
SATURATING_WARPS = 16


@dataclass(frozen=True)
class LaunchShape:
    """The kernel's launch for one sweep: the padded state dimension, lanes
    per member, members per warp, warps per block, blocks, shared bytes per
    block, the blocks the card keeps resident on one SM, and the compiler's
    registers and local (spilled) bytes per thread."""

    columns: int
    lanes_per_member: int
    members_per_warp: int
    warps_per_block: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    registers: int
    local_bytes: int

    @property
    def warps_per_sm(self) -> int:
        return self.blocks_per_sm * self.warps_per_block


def _shape(lib, n: int, k: int, mode_id: int, batch: int, warps: int) -> LaunchShape:
    out = (ctypes.c_longlong * 9)()
    code = lib.sweep_magnus2_shape(n, k, mode_id, batch, warps, out)
    if code != 0:
        raise ValueError(f"the sweep_magnus2 kernel refuses n={n}, k={k}, {warps} warps: "
                         f"{lib.sweep_magnus2_error_string(code).decode()}")
    return LaunchShape(*list(out))


def wave_cost(shape: LaunchShape, sms: int) -> int:
    """The estimated time of a launch in units of one saturated wave's: each
    wave of blocks over the ``sms`` SMs costs its warps per SM, at least
    :data:`SATURATING_WARPS` (below that a step is a latency chain whose
    time does not shrink with fewer warps)."""
    per_wave = shape.blocks_per_sm * sms
    full, rest = divmod(shape.blocks, per_wave)
    cost = full * max(shape.warps_per_sm, SATURATING_WARPS)
    if rest:
        cost += max(-(-rest // sms) * shape.warps_per_block, SATURATING_WARPS)
    return cost


@functools.lru_cache(maxsize=256)
def _best_warps(lib, n: int, k: int, mode_id: int, batch: int, sms: int) -> int:
    """The warps per block whose launch has the least :func:`wave_cost`, the
    fewest on a tie (more blocks to spread over the SMs)."""
    best, best_cost = 0, None
    for warps in range(1, MAX_WARPS_PER_BLOCK + 1):
        if lib.sweep_magnus2_smem_bytes(n, k, mode_id, warps) > MAX_SHARED_BYTES:
            break
        shape = _shape(lib, n, k, mode_id, batch, warps)
        if shape.blocks_per_sm < 1:
            break
        cost = wave_cost(shape, sms)
        if best_cost is None or cost < best_cost:
            best, best_cost = warps, cost
    if best == 0:
        raise ValueError(
            f"the sweep_magnus2 kernel cannot fit one warp of n={n}, k={k} on an SM."
        )
    return best


def warps_per_block(n: int, k: int, mode: str, batch: int) -> int:
    """The block size the wrapper launches on the current CUDA device (see
    :func:`wave_cost`). Needs the card."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return _best_warps(_kernel_lib(), n, k, _MODES.index(mode), batch, sms)


def launch_shape(n: int, k: int, mode: str, batch: int,
                 warps: Optional[int] = None) -> LaunchShape:
    """The launch the kernel takes on the current CUDA device for ``batch``
    members (``warps`` per block, by default :func:`warps_per_block`). Needs
    the card: it builds and asks the library."""
    if warps is None:
        warps = warps_per_block(n, k, mode, batch)
    return _shape(_kernel_lib(), n, k, _MODES.index(mode), batch, int(warps))


def _launch_kernel(inputs: SweepInputs, warps: Optional[int] = None):
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch
    if n > MAX_N:
        raise ValueError(f"the CUDA sweep_magnus2 kernel takes n <= {MAX_N}; got n={n}.")
    if inputs.real != torch.float32:
        raise TypeError(
            "the CUDA sweep_magnus2 kernel runs float32 only; float64 sweeps on the card run "
            "on kernel B8 (ops/df_sweep.py, fused_sweep_solve(precision='df32'))."
        )
    device = inputs.y0r.device
    mode_id = _MODES.index(inputs.mode)
    lib = _kernel_lib()
    with torch.cuda.device(device):
        if warps is None:
            warps = warps_per_block(n, k, inputs.mode, B)
    outr = torch.empty((n, B), dtype=torch.float32, device=device)
    outi = torch.empty_like(outr)
    evalr = torch.zeros((inputs.n_eval, n, B), dtype=torch.float32, device=device)
    evali = torch.zeros_like(evalr)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    c1, c2 = _step_constants(inputs.dt)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sweep_magnus2_launch(
            ptr(inputs.statr), ptr(inputs.stati), ptr(inputs.opsr), ptr(inputs.opsi),
            ptr(inputs.phases), ptr(inputs.coef), ptr(inputs.slots), ptr(inputs.y0r),
            ptr(inputs.y0i), ptr(outr), ptr(outi), ptr(evalr), ptr(evali),
            n, k, T, B, inputs.order, mode_id, int(warps), c1, c2, stream,
        )
    if code != 0:
        raise RuntimeError(
            f"sweep_magnus2 kernel launch failed: {lib.sweep_magnus2_error_string(code).decode()}"
        )
    sweep_expm_magnus2.launches += 1
    final = torch.complex(outr, outi)
    return final, (torch.complex(evalr, evali) if inputs.n_eval else None)


def _step_constants(dt: float) -> Tuple[float, float]:
    """``dt / 2`` and ``p2 dt^2`` in float64 (each is rounded once to the
    working dtype where it is used)."""
    return 0.5 * dt, _P2 * dt * dt


# ---------------------------------------------------------------------------
# Plain version: the kernel's arithmetic, batched over members
# ---------------------------------------------------------------------------
# Layout (B, n, n) / (B, n). Every sum over the inner index is taken in
# order, one term at a time, and every complex product is
# (a_r b_r - a_i b_i, a_r b_i + a_i b_r); scalars are rounded to the working
# dtype before they multiply, as the kernel's float arguments are. The
# kernel fuses multiply-adds and splits its sums, so the two agree to
# roundoff.
def _matmul(ar, ai, br, bi):
    """(A @ B) for (B, n, n) planes, summed over the inner index in order."""
    accr = torch.zeros_like(ar)
    acci = torch.zeros_like(ai)
    for m in range(ar.shape[-1]):
        xr, xi = ar[:, :, m, None], ai[:, :, m, None]
        yr, yi = br[:, None, m, :], bi[:, None, m, :]
        accr = accr + (xr * yr - xi * yi)
        acci = acci + (xr * yi + xi * yr)
    return accr, acci


def _matvec(ar, ai, xr, xi):
    """(A @ x) for (B, n, n) planes and (B, n) vectors, summed in order."""
    accr = torch.zeros_like(xr)
    acci = torch.zeros_like(xi)
    for m in range(ar.shape[-1]):
        cr, ci = ar[:, :, m], ai[:, :, m]
        vr, vi = xr[:, m, None], xi[:, m, None]
        accr = accr + (cr * vr - ci * vi)
        acci = acci + (cr * vi + ci * vr)
    return accr, acci


def sweep_expm_magnus2_plain(inputs: SweepInputs):
    """The plain version on any device: ``(final, trajectory or None)``."""
    real, device = inputs.real, inputs.y0r.device
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch

    def scalar(x):
        return torch.tensor(x, dtype=real, device=device)

    c1_f, c2_f = _step_constants(inputs.dt)
    c1, c2 = scalar(c1_f), scalar(c2_f)
    statr, stati = inputs.statr[None], inputs.stati[None]
    yr, yi = inputs.y0r.T.contiguous(), inputs.y0i.T.contiguous()  # (B, n)
    traj = torch.zeros((2, max(inputs.n_eval, 1), B, n), dtype=real, device=device)
    slots = None if inputs.slots is None else inputs.slots.tolist()

    cos_t, sin_t = phase_matrices(inputs.phases, n)

    def generator(step, g):
        cos_p, sin_p = cos_t[step, g], sin_t[step, g]
        accr, acci = statr, stati
        for j in range(k):
            c = inputs.coef[step, g, j][:, None, None]  # (B, 1, 1)
            accr = accr + c * inputs.opsr[j]
            acci = acci + c * inputs.opsi[j]
        return accr * cos_p - acci * sin_p, accr * sin_p + acci * cos_p

    for step in range(T):
        g1r, g1i = generator(step, 0)
        g2r, g2i = generator(step, 1)
        if inputs.mode == "matvec":
            vr, vi = yr, yi
            for kk in range(inputs.order, 0, -1):
                inv = scalar(1.0 / kk)
                u1r, u1i = _matvec(g1r, g1i, vr, vi)
                u2r, u2i = _matvec(g2r, g2i, vr, vi)
                t1r, t1i = _matvec(g2r, g2i, u1r, u1i)
                ar, ai = _matvec(g1r, g1i, u2r, u2i)
                vr = yr + inv * (c1 * (u1r + u2r) + c2 * (t1r - ar))
                vi = yi + inv * (c1 * (u1i + u2i) + c2 * (t1i - ai))
        else:
            pr, pi = _matmul(g2r, g2i, g1r, g1i)  # P = G2 @ G1
            if inputs.mode == "matrix_herm":
                mr = c1 * (g1r + g2r) + c2 * (pr - pr.transpose(1, 2))
                mi = c1 * (g1i + g2i) + c2 * (pi + pi.transpose(1, 2))
            else:
                qr, qi = _matmul(g1r, g1i, g2r, g2i)  # G1 @ G2
                mr = c2 * pr + (-c2) * qr
                mi = c2 * pi + (-c2) * qi
                mr = mr + c1 * (g1r + g2r)
                mi = mi + c1 * (g1i + g2i)
            vr, vi = yr, yi
            for kk in range(inputs.order, 0, -1):
                inv = scalar(1.0 / kk)
                wr, wi = _matvec(mr, mi, vr, vi)
                vr, vi = yr + inv * wr, yi + inv * wi
        yr, yi = vr, vi
        if slots is not None and slots[step] >= 0:
            traj[0, slots[step]] = yr
            traj[1, slots[step]] = yi

    final = torch.complex(yr.T, yi.T).contiguous()
    trajectory = None
    if inputs.n_eval:
        trajectory = torch.complex(traj[0], traj[1]).transpose(1, 2).contiguous()
    return final, trajectory
