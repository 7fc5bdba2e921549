r"""Member-major fixed-step Magnus-2/3 sweep for large dimensions: CUDA kernel
and plain version.

Counterpart of ``qiskit_dynamics_tpu/ops/member_sweep.py``. The same sweep
as :func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`
(``y'_b = G_b(t) y_b``, ``G_b(t) = P(t) o (S + sum_j c_{b,j}(t) O_j)``, T fixed
steps, Horner Taylor action), laid out for ``32 < n <= 128``: each member's
``(n, n)`` matrices stay on chip for the whole time loop, so nothing of size
``B n^2`` ever reaches device memory. Two step rules:

- ``magnus=2`` (4th order, 2-point Gauss):
  ``M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1]``;
- ``magnus=3`` (6th order, 3-point Gauss, Blanes et al.), ``n <= 64``:
  ``a1 = dt G_2``, ``a2 = (sqrt(15)/3) dt (G_3 - G_1)``,
  ``a3 = (10/3) dt (G_3 - 2 G_2 + G_1)``, ``C1 = [a1, a2]``,
  ``C2 = [2 a3 + C1, a1] / 60``,
  ``M = a1 + a3/12 + [-20 a1 - a3 + C1, a2 + C2] / 240``.

The shared static and operator tables are frame-rotated once per Gauss point
(the rotation is elementwise-linear) and each member combines the rotated
tables with its coefficients. With ``hermitian`` the plain version forms every
bracket from one product, ``[A, B] = P - P^H`` with ``P = A B``; the kernel
does so at Magnus-2 and forms Magnus-3's brackets as ``A B - B A`` either way
(the same function to roundoff; ``csrc/member_sweep.cu`` says why).

Two implementations of the same arithmetic:

- ``csrc/member_sweep.cu``: the kernel for Hopper, complex64 state, float64
  frame phases, matrix products on the tensor cores in 3xTF32 (float32
  accuracy). It sums its products in its own order.
- :func:`sweep_expm_magnus2_member_plain`: eager PyTorch on any device,
  batched over members, complex64 or (for float64 coefficients) complex128.
  The two agree to float32 roundoff.

:func:`sweep_expm_magnus2_member` runs the kernel for CUDA tensors (and
raises if it cannot) and the plain version for CPU tensors.

Not carried from the JAX package: its Mosaic layout variants, which compute
the same polynomial (``horner="vpu"|"hybrid"|"bvpu"``, ``build="batched"``,
``resident``, ``hoist_rotation``, ``block_m``), and ``interpret``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..unified import default_device, to_tensor
from ..utils.metrics import span
from .sweep_solver import _M3_C0, _M3_C1, _P2, _TWO_PI, MAX_SHARED_BYTES, gauss_nodes

__all__ = ["sweep_expm_magnus2_member", "sweep_expm_magnus2_member_plain", "prepare_inputs"]

MAX_N = 128  # the kernel's cap on the state dimension
MAX_N_MAGNUS3 = 64  # and for magnus=3
_SCRATCH_BLOCKS_PER_SM = 2  # persistent grid when the matrices live in device memory


@dataclass
class MemberInputs:
    """Validated inputs on one device: complex tables, float64 phases."""

    static: torch.Tensor  # (n, n) complex
    ops: torch.Tensor  # (k, n, n) complex
    omega: torch.Tensor  # (n, n) float64
    coef: torch.Tensor  # (T, magnus, k, B) real
    y0: torch.Tensor  # (n, B) complex
    dt: float
    t0: float
    order: int
    hermitian: bool
    magnus: int

    @property
    def n(self) -> int:
        return self.static.shape[0]

    @property
    def k(self) -> int:
        return self.ops.shape[0]

    @property
    def steps(self) -> int:
        return self.coef.shape[0]

    @property
    def batch(self) -> int:
        return self.coef.shape[-1]

    @property
    def real(self) -> torch.dtype:
        return self.coef.dtype


def prepare_inputs(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, order=8, hermitian=False,
    magnus=2,
) -> MemberInputs:
    """Validate the arguments of :func:`sweep_expm_magnus2_member` and move
    them to the device of ``y0`` (the CUDA device when ``y0`` is not a
    tensor), in the dtype of ``coefficients`` (float64 stays float64,
    anything else is float32). The tensors are detached: this function and
    :func:`sweep_expm_magnus2_member` are not differentiable
    (:func:`~qiskit_dynamics_tpu_torch.ops.sweep_ad.sweep_expm_magnus2_member_ad` is)."""
    if magnus not in (2, 3):
        raise ValueError(f"magnus must be 2 or 3, got {magnus!r}")
    device = y0.device if isinstance(y0, torch.Tensor) else default_device()
    coef = to_tensor(coefficients, device=device).detach()
    real = torch.float64 if coef.dtype == torch.float64 else torch.float32
    cplx = torch.complex128 if real == torch.float64 else torch.complex64
    coef = coef.to(real).contiguous()
    if coef.ndim != 4:
        raise ValueError(f"coefficients must be (T, magnus, k, B); got {tuple(coef.shape)}")
    T, n_gauss, k, B = coef.shape
    if n_gauss != magnus:
        raise ValueError(
            f"coefficients carry {n_gauss} Gauss-point samples per step but magnus={magnus} "
            f"needs exactly {magnus}."
        )
    static = to_tensor(static_op, device=device).detach().to(cplx).contiguous()
    ops = to_tensor(operators, device=device).detach().to(cplx).contiguous()
    y0 = to_tensor(y0, device=device).detach().to(cplx).contiguous()
    n = static.shape[0]
    if static.shape != (n, n) or ops.shape != (k, n, n) or y0.shape != (n, B):
        raise ValueError(
            f"shape mismatch: y0 {tuple(y0.shape)}, static {tuple(static.shape)}, operators "
            f"{tuple(ops.shape)}, coefficients {tuple(coef.shape)}"
        )
    return MemberInputs(
        static=static, ops=ops,
        omega=to_tensor(frame_omega, dtype=torch.float64, device=device).reshape(n, n).contiguous(),
        coef=coef, y0=y0, dt=float(dt), t0=float(t0), order=int(order),
        hermitian=bool(hermitian), magnus=int(magnus),
    )


def sweep_expm_magnus2_member(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, order=8, hermitian=False,
    magnus=2,
):
    r"""Fixed-step Magnus-2 or Magnus-3 sweep solve, member-major.

    Runs the CUDA kernel when ``y0`` is a CUDA tensor (float32, ``n <= 128``,
    ``n <= 64`` for ``magnus=3``; it raises for anything it cannot launch) and
    the plain version when ``y0`` lies on the CPU. The other arguments are
    moved to the device of ``y0``.

    Args:
        static_op, operators, frame_omega, y0, dt, t0, order, hermitian: as
            :func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`.
        coefficients: (T, magnus, k, B) real signal values at the Gauss
            points of every step. Its dtype sets the arithmetic: float64 runs
            the plain version in float64 (CPU only), anything else float32.
        magnus: 2 or 3, the step rule (see the module docstring).

    Returns:
        (n, B) complex final states in the frame basis at ``t0 + T dt``. Any
        ``B``: the kernel gives each member its own block, so no lanes are
        padded.
    """
    with span("sweep.prepare"):
        inputs = prepare_inputs(
            static_op, operators, frame_omega, coefficients, y0, dt, t0=t0, order=order,
            hermitian=hermitian, magnus=magnus,
        )
    with span("sweep.engine"):
        if inputs.y0.is_cuda:
            return _launch_kernel(inputs)
        if inputs.y0.device.type == "cpu":
            return sweep_expm_magnus2_member_plain(inputs)
    raise RuntimeError(f"sweep_expm_magnus2_member has no path for device {inputs.y0.device}.")


# the number of times the CUDA kernel was launched (reset by callers that count)
sweep_expm_magnus2_member.launches = 0


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
_PTR = ctypes.c_void_p
_ARGTYPES = (
    [_PTR] * 12 + [ctypes.c_int] * 9 + [ctypes.c_double] * 5 + [ctypes.c_float] * 5 + [_PTR]
)


def _kernel_lib():
    from ..kernels import _build

    lib = _build.load("member_sweep")
    lib.member_sweep_launch.argtypes = _ARGTYPES
    lib.member_sweep_launch.restype = ctypes.c_int
    lib.member_sweep_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.member_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.member_sweep_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.member_sweep_blocks_per_sm.restype = ctypes.c_int
    lib.member_sweep_matrix_elems.argtypes = [ctypes.c_int]
    lib.member_sweep_matrix_elems.restype = ctypes.c_size_t
    lib.member_sweep_table_elems.argtypes = [ctypes.c_int] * 4
    lib.member_sweep_table_elems.restype = ctypes.c_size_t
    lib.member_sweep_error_string.argtypes = [ctypes.c_int]
    lib.member_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _step_constants(dt: float):
    """``dt/2``, ``p2 dt^2``, ``dt``, ``(sqrt(15)/3) dt`` and ``(10/3) dt`` in
    float64 (each is rounded once to the working dtype where it is used)."""
    return 0.5 * dt, _P2 * dt * dt, dt, _M3_C0 * dt, _M3_C1 * dt


def _launch_kernel(inputs: MemberInputs) -> torch.Tensor:
    n, k, T, B, magnus = inputs.n, inputs.k, inputs.steps, inputs.batch, inputs.magnus
    if n > MAX_N:
        raise ValueError(f"the CUDA member_sweep kernel takes n <= {MAX_N}; got n={n}.")
    if magnus == 3 and n > MAX_N_MAGNUS3:
        raise ValueError(
            f"the CUDA member_sweep kernel takes n <= {MAX_N_MAGNUS3} for magnus=3; got n={n}."
        )
    if inputs.real != torch.float32:
        raise TypeError(
            "the CUDA member_sweep kernel runs float32 only; its complex128 mode is queued "
            "(ROADMAP, left from A8)."
        )
    device = inputs.y0.device
    lib = _kernel_lib()
    in_shared = lib.member_sweep_smem_bytes(n, k, 1) <= MAX_SHARED_BYTES
    if in_shared:
        grid, scratch = B, None
    else:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = min(B, _SCRATCH_BLOCKS_PER_SM * sms)
        scratch = torch.empty(
            (grid * lib.member_sweep_matrix_elems(n), 2), dtype=torch.float32,
            device=device,
        )
    table = torch.empty(
        (lib.member_sweep_table_elems(n, k, T, magnus), 2), dtype=torch.float32, device=device
    )

    def planes(x):
        return torch.real(x).contiguous(), torch.imag(x).contiguous()

    statr, stati = planes(inputs.static)
    opsr, opsi = planes(inputs.ops)
    y0r, y0i = planes(inputs.y0)
    outr = torch.empty((n, B), dtype=torch.float32, device=device)
    outi = torch.empty_like(outr)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    nodes = gauss_nodes(magnus) + ((0.0,) if magnus == 2 else ())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.member_sweep_launch(
            ptr(statr), ptr(stati), ptr(opsr), ptr(opsi), ptr(inputs.omega), ptr(inputs.coef),
            ptr(y0r), ptr(y0i), ptr(outr), ptr(outi), ptr(table), ptr(scratch),
            n, k, T, B, inputs.order, magnus, int(inputs.hermitian), int(in_shared), grid,
            inputs.dt, inputs.t0, *nodes, *_step_constants(inputs.dt), stream,
        )
    if code != 0:
        raise RuntimeError(
            f"member_sweep kernel launch failed: {lib.member_sweep_error_string(code).decode()}"
        )
    sweep_expm_magnus2_member.launches += 1
    return torch.complex(outr, outi)


# ---------------------------------------------------------------------------
# Plain version: the kernel's arithmetic, batched over members
# ---------------------------------------------------------------------------
def sweep_expm_magnus2_member_plain(inputs: MemberInputs) -> torch.Tensor:
    """The plain version on any device: (n, B) final states. It holds a few
    ``(B, n, n)`` complex tensors at a time."""
    real, cplx = inputs.real, inputs.y0.dtype
    c1, c2, dtf, c0dt, c1dt = _step_constants(inputs.dt)

    def comm(a, b):
        p = a @ b
        if inputs.hermitian:
            return p - p.conj().transpose(-1, -2)
        return p - b @ a

    def generators(step):
        out = []
        for g, node in enumerate(gauss_nodes(inputs.magnus)):
            tau = inputs.t0 + (step + node) * inputs.dt
            ph = torch.fmod(inputs.omega * tau, _TWO_PI)
            rot = torch.complex(torch.cos(ph).to(real), torch.sin(ph).to(real))
            acc = (inputs.static * rot)[None]
            for j in range(inputs.k):  # rotated tables first, member combination second
                acc = acc + inputs.coef[step, g, j].to(cplx)[:, None, None] * (inputs.ops[j] * rot)
            out.append(acc)
        return out

    y = inputs.y0.T[..., None]  # (B, n, 1)
    for step in range(inputs.steps):
        if inputs.magnus == 2:
            g1, g2 = generators(step)
            m = c1 * (g1 + g2) + c2 * comm(g2, g1)
        else:
            g1, g2, g3 = generators(step)
            a2 = c0dt * (g3 - g1)
            a1 = dtf * g2
            a3 = c1dt * (g3 - 2.0 * g2 + g1)
            bracket = comm(a1, a2)
            m = a1 + (1.0 / 12.0) * a3
            big_y = -20.0 * a1 - a3 + bracket
            big_x = 2.0 * a3 + bracket
            z = a2 + (1.0 / 60.0) * comm(big_x, a1)
            m = m + (1.0 / 240.0) * comm(big_y, z)
        v = y
        for kk in range(inputs.order, 0, -1):
            v = y + (1.0 / kk) * (m @ v)
        y = v
    return y[..., 0].T.contiguous()
