r"""Fixed-step Magnus-2/3 sweep in native FP64: CUDA kernel B8 and plain version.

Counterpart of ``qiskit_dynamics_tpu/ops/df_sweep.py`` (the XLA engine) and
``qiskit_dynamics_tpu/ops/df_sweep_pallas.py`` (the Pallas kernel). The JAX
package runs this sweep in double-float32 because the TPU has no FP64; the
H100 has it, so the same step rules run here in float64/complex128. Per step
of a possibly non-uniform grid the frame-basis generator
``G_b(t) = P(t) o (S + sum_j c_{b,j}(t) O_j)`` is sampled at the Gauss nodes,
combined by the Magnus order-4 (two-node) or order-6 (three-node) rule, and
applied to the state by a Horner Taylor action ``y <- sum_{j <= order} M^j y / j!``
(the propagator is never formed).

Two implementations of the same arithmetic:

- ``csrc/df_magnus_sweep.cu``: the kernel for Hopper, complex128, one kernel
  for both of the JAX package's engines (per-step ``dt``, trajectory slots,
  the one-product anti-Hermitian commutator, any batch size): one warp per
  member, the rule's products on the FP64 tensor cores, the frame-rotated
  tables formed once per call by a first kernel (:func:`rotated_tables`
  picks their layout by size, :func:`launch_shape` the members per block).
- :func:`sweep_expm_magnus_df_plain`: eager complex128 PyTorch, one step at a
  time, batched over members, on any device.

:func:`sweep_expm_magnus_df` (and :func:`sweep_expm_magnus_df_pallas`, the
same launch under the Pallas entry point's name) runs the kernel for a
``y0`` on the card and the plain version for a ``y0`` on the CPU. The
kernel has two sweeps: the tensor-core one up to ``MAX_N``
(``csrc/df_magnus_sweep.cu``) and, above it up to ``MAX_WIDE_N``, one block
per member with FP64 products on the FP64 pipes (``csrc/df_magnus_wide.cu``);
:func:`kernel_for` picks one by n.

Not carried: the double-float32 helpers (``_dfi`` ... ``_comm32``), the
host-link workarounds ``_frame_phases_from_diag`` and
``_combine_factor_table`` (the tables are formed on the device in float64),
and the Pallas entry point's ``tile_b``, ``interpret`` and ``unroll``.
``fast_commutators`` and ``horner_df_tail`` are accepted and do nothing:
every operation is FP64 here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import MAX_SHARED_BYTES, Library
from ..unified import default_device, to_tensor
from .magnus_rule import MAGNUS_NODES, TWO_PI, step_constants, validate_eval_slots

__all__ = [
    "MAGNUS_NODES",
    "sweep_expm_magnus_df",
    "sweep_expm_magnus_df_pallas",
    "sweep_expm_magnus_df_plain",
    "prepare_df_inputs",
]

MAX_N = 32  # the tensor-core sweep pads n with zeros to 8, 16, 24 or 32
MAX_WIDE_N = 256  # the one-block-per-member sweep above MAX_N (kWideMaxN)


def kernel_for(n: int) -> str:
    """Which sweep of kernel B8 a solve dimension ``n`` runs: ``"dmma"``
    (one warp per member, products on the FP64 tensor cores) up to
    ``MAX_N``, ``"wide"`` (one block per member) above it."""
    return "dmma" if n <= MAX_N else "wide"


MAX_MEMBERS_PER_BLOCK = 8  # warps per block, one member each
SMS = 132  # streaming multiprocessors of an H100 SXM
SM_SHARED_BYTES = 233472  # shared memory of one SM (228 KB)
BLOCK_RESERVED_BYTES = 1024  # shared memory the runtime keeps per block
MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM = 32, 64
ROTATED_TABLE_BYTES = 40 << 20  # the rotated tables' limit; the (cos, sin) table above it


def _rule_consts(magnus_order: int, order: int):
    """dt-free float64 scalars of the step rule and of the Horner action."""
    inv_j = 1.0 / np.arange(1, order + 1, dtype=np.float64)
    if magnus_order == 2:
        return (inv_j,)
    return (2.0, 20.0, 1.0 / 12, 1.0 / 60, 1.0 / 240, inv_j)


@dataclass
class DfInputs:
    """Kernel-ready inputs on one device: complex128 operators and states,
    float64 tables."""

    static: torch.Tensor  # (n, n) complex128
    ops: torch.Tensor  # (k, n, n) complex128
    omega: torch.Tensor  # (n, n) float64
    taus: torch.Tensor  # (T, n_nodes) absolute node times
    step: torch.Tensor  # (T, 3) step constants
    coef: torch.Tensor  # (T, n_nodes, k, B) float64
    y0: torch.Tensor  # (n, B) complex128
    slots: Optional[torch.Tensor]  # (T,) int32, or None
    n_eval: int
    order: int
    magnus_order: int
    hermitian: bool

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
        return self.y0.shape[1]


def _factor_table(coef_factors, taus: torch.Tensor, k: int, device) -> torch.Tensor:
    """The (T, n_nodes, k, B) float64 coefficient table from factors, on the
    device: ``Re[sum_r A[j, r, b] e^{i 2 pi nu[j, r] tau}]`` for carriers
    ``nu`` (k, R), or ``Re[sum_r A[j, r, b] P[t, node, j, r]]`` for a complex
    profile ``P`` (T, n_nodes, k, R)."""
    amps = to_tensor(coef_factors[0], device=device).to(torch.complex128)
    if amps.ndim != 3 or amps.shape[0] != k:
        raise ValueError(
            f"coef_factors amplitudes must be (k={k}, R, B); got {tuple(amps.shape)}."
        )
    second = to_tensor(coef_factors[1], device=device)
    if second.ndim == 4:
        want = tuple(taus.shape) + (k, amps.shape[1])
        if tuple(second.shape) != want:
            raise ValueError(
                f"coef_factors profile must be shaped {want}; got {tuple(second.shape)}."
            )
        waves = second.to(torch.complex128)
    else:
        carriers = second.to(torch.float64)
        if tuple(carriers.shape) != tuple(amps.shape[:2]):
            raise ValueError(
                f"coef_factors carriers must be shaped {tuple(amps.shape[:2])}; "
                f"got {tuple(carriers.shape)}."
            )
        theta = torch.fmod(TWO_PI * carriers * taus[:, :, None, None], TWO_PI)
        waves = torch.polar(torch.ones_like(theta), theta)  # (T, n_nodes, k, R)
    return torch.real(torch.einsum("tgjr,jrb->tgjb", waves, amps)).contiguous()


def prepare_df_inputs(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, magnus_order=3, order=12,
    hermitian=False, coef_factors=None, eval_slots=None,
) -> DfInputs:
    """Validate the arguments of :func:`sweep_expm_magnus_df` and place them
    on the device of ``y0`` (the CUDA device when ``y0`` is not a tensor).
    Inputs are detached: this sweep is not differentiable (as in the JAX
    package)."""
    if magnus_order not in MAGNUS_NODES:
        raise ValueError(f"magnus_order must be one of {sorted(MAGNUS_NODES)}.")
    device = y0.device if isinstance(y0, torch.Tensor) else default_device()

    def complex_tensor(x):
        return to_tensor(x, device=device).detach().to(torch.complex128).contiguous()

    static = complex_tensor(static_op)
    ops = complex_tensor(operators)
    y0 = complex_tensor(y0)
    n, k = y0.shape[0], ops.shape[0]
    nodes = MAGNUS_NODES[magnus_order]
    dts = np.asarray(dt.detach().cpu() if isinstance(dt, torch.Tensor) else dt, dtype=np.float64)
    if coef_factors is not None:
        if coefficients is not None:
            raise ValueError("pass either coefficients or coef_factors, not both.")
        if dts.ndim != 1:
            raise ValueError(
                "coef_factors requires dt as a (T,) per-step array (the step count is "
                "otherwise unknown)."
            )
        T = len(dts)
    else:
        coef = to_tensor(coefficients, device=device).detach().to(torch.float64).contiguous()
        if coef.ndim != 4:
            raise ValueError(f"coefficients must be (T, n_nodes, k, B); got {tuple(coef.shape)}")
        T, n_nodes, k_coef, _ = coef.shape
        if n_nodes != len(nodes):
            raise ValueError(
                f"coefficients have {n_nodes} node samples; magnus_order={magnus_order} needs "
                f"{len(nodes)}."
            )
        if k_coef != k:
            raise ValueError(f"coefficients have {k_coef} signals; operators have {k}.")
        if dts.ndim == 0:
            dts = np.full(T, float(dts))
        if dts.shape != (T,):
            raise ValueError(f"dt must be a scalar or shape ({T},), got {dts.shape}.")
    # the node times in host float64, as the JAX package forms them
    t_start = float(t0) + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    taus_np = t_start[:, None] + dts[:, None] * nodes[None, :]
    taus = torch.as_tensor(taus_np, device=device)
    if coef_factors is not None:
        coef = _factor_table(coef_factors, taus, k, device)
    B = coef.shape[-1]
    if y0.shape != (n, B) or static.shape != (n, n) or ops.shape != (k, n, n):
        raise ValueError(
            f"shape mismatch: y0 {tuple(y0.shape)}, static {tuple(static.shape)}, operators "
            f"{tuple(ops.shape)}, coefficients {tuple(coef.shape)}"
        )
    step = np.zeros((T, 3))
    step[:, : magnus_order] = np.stack(step_constants(magnus_order, dts), axis=1)
    slots, n_eval = None, 0
    if eval_slots is not None:
        n_eval = validate_eval_slots(eval_slots, T)
        slots = torch.as_tensor(np.asarray(eval_slots, dtype=np.int32), device=device)
    return DfInputs(
        static=static, ops=ops,
        omega=to_tensor(frame_omega, dtype=torch.float64, device=device).reshape(n, n).contiguous(),
        taus=taus, step=torch.as_tensor(step, device=device), coef=coef, y0=y0, slots=slots,
        n_eval=n_eval, order=int(order), magnus_order=int(magnus_order), hermitian=bool(hermitian),
    )


def sweep_expm_magnus_df(
    static_op, operators, frame_omega, coefficients, y0, dt, t0: float = 0.0,
    magnus_order: int = 3, order: int = 12, chunk_b: int = 2048, hermitian: bool = False,
    fast_commutators: bool = True, horner_df_tail: int = 6, coef_factors=None, devices=None,
    eval_slots=None,
):
    r"""Fixed-step Magnus sweep (order 2 or 3 rule) in float64/complex128.

    Runs kernel B8 when ``y0`` is a CUDA tensor and the plain version when it
    lies on the CPU; the other arguments are moved to the device of ``y0``
    (the CUDA device when ``y0`` is not a tensor).

    Args:
        static_op: (n, n) complex static generator (frame basis, diagonal removed).
        operators: (k, n, n) complex signal operators (frame basis).
        frame_omega: (n, n) real frame frequency-difference matrix.
        coefficients: (T, n_nodes, k, B) float64 signal values at the Gauss
            nodes of every step, ``t_start[step] + MAGNUS_NODES[order] * dt[step]``.
        y0: (n, B) complex initial states (frame basis).
        dt: a scalar (uniform grid) or a (T,) array of per-step sizes.
        t0: initial time (frame phases use absolute time).
        magnus_order: 2 (two-node, 4th-order rule) or 3 (three-node, 6th order).
        order: Taylor order of the expm action.
        chunk_b: members per kernel launch (and per plain-version batch).
        hermitian: the generators are anti-Hermitian (``G = -iH``): every
            commutator is then one product (the caller guarantees it).
        fast_commutators, horner_df_tail: the JAX package's double-float32
            mixed-precision options; accepted, and no-ops (all of it is FP64).
        coef_factors: ``(A, carriers)`` with ``A`` (k, R, B) complex member
            amplitudes and ``carriers`` (k, R) float64, or ``(A, P)`` with a
            complex (T, n_nodes, k, R) profile ``P``: the coefficient table
            is then formed on the device in float64. ``coefficients`` must be
            ``None`` and ``dt`` a (T,) array.
        devices: multi-device dispatch; waits for ROADMAP A13 (raises).
        eval_slots: optional length-T tuple: after step ``s`` the state is
            stored into trajectory slot ``eval_slots[s]`` if ``>= 0``.

    Returns:
        (n, B) complex128 final states (frame basis) at ``t0 + sum(dt)`` on
        the device of ``y0``; with ``eval_slots``, ``(final, trajectory)``
        with the trajectory (n_eval, n, B).
    """
    del fast_commutators, horner_df_tail  # every operation is FP64 here
    if devices is not None:
        raise NotImplementedError(
            "sweep_expm_magnus_df(devices=...) waits for ROADMAP A13 (multi-device, "
            "torch.distributed)."
        )
    inputs = prepare_df_inputs(
        static_op, operators, frame_omega, coefficients, y0, dt, t0=t0,
        magnus_order=magnus_order, order=order, hermitian=hermitian, coef_factors=coef_factors,
        eval_slots=eval_slots,
    )
    if chunk_b < 1:
        raise ValueError(f"chunk_b must be positive; got {chunk_b}")
    if inputs.y0.is_cuda:
        final, traj = _launch_kernel(inputs, int(chunk_b))
    elif inputs.y0.device.type == "cpu":
        final, traj = sweep_expm_magnus_df_plain(inputs, int(chunk_b))
    else:
        raise RuntimeError(f"sweep_expm_magnus_df has no path for device {inputs.y0.device}.")
    return final if traj is None else (final, traj)


def sweep_expm_magnus_df_pallas(
    static_op, operators, frame_omega, coefficients, y0, dt: float, t0: float = 0.0,
    magnus_order: int = 3, order: int = 12,
):
    """The JAX package's Pallas entry point: a uniform grid and a full
    coefficient table, the same kernel B8 as :func:`sweep_expm_magnus_df`.
    Its ``tile_b``, ``interpret`` and ``unroll`` are not carried (the kernel
    masks its own last block)."""
    return sweep_expm_magnus_df(
        static_op, operators, frame_omega, coefficients, y0, float(dt), t0=t0,
        magnus_order=magnus_order, order=order,
    )


# ---------------------------------------------------------------------------
# CUDA kernel launch
# ---------------------------------------------------------------------------
_LIB = Library("df_magnus_sweep", {
    "df_magnus_sweep_tables": "p6 i5 s",
    "df_magnus_sweep_launch": "p8 i11 s",
    "df_magnus_sweep_product": "p3 i2 s",
    "df_magnus_sweep_smem_bytes": "i5 -> z",
    "df_magnus_sweep_active_blocks": "i5 -> i",
})
_WIDE_LIB = Library("df_magnus_wide", {
    "df_magnus_wide_work_bytes": "i4 -> q",
    "df_magnus_wide_launch": "p11 i9 s",
})


def padded(n: int) -> int:
    """The kernel's padded dimension: n rounded up to a multiple of 8 (the
    FP64 tensor-core tile)."""
    return -(-n // 8) * 8


def member_smem_bytes(n: int, k: int, n_nodes: int) -> int:
    """Shared memory of one member (warp) of the kernel: three complex planes
    of padded(n)^2 (five for Magnus-3 above 16, whose owned matrices then
    leave the registers), two Horner vectors and the step's n_nodes k
    coefficients. ``df_magnus_sweep_smem_bytes`` of the library is mb times
    this."""
    np_ = padded(n)
    planes = 3 + (2 if n_nodes == 3 and np_ > 16 else 0)
    return 16 * (planes * np_ * np_ + 2 * np_ + (n_nodes * k + 1) // 2)


def rotated_tables(n: int, k: int, n_nodes: int, T: int) -> bool:
    """The call's table layout, by size: the frame-rotated operators (T,
    n_nodes, k + 1, np, np) while they take at most ``ROTATED_TABLE_BYTES``,
    else the (cos, sin) table (T, n_nodes, np, np)."""
    return T * n_nodes * (k + 1) * padded(n) ** 2 * 16 <= ROTATED_TABLE_BYTES


@dataclass(frozen=True)
class LaunchShape:
    members_per_block: int
    blocks: int
    members_per_sm: int  # by the shared-memory and block reckoning (registers not counted)
    smem_bytes: int  # of one block


def launch_shape(n: int, k: int, n_nodes: int, hermitian: bool, B: int) -> LaunchShape:
    """Blocks of the kernel for a launch of B members (one warp each).

    Members per block: the power of two up to ``MAX_MEMBERS_PER_BLOCK`` that
    keeps the most members resident per SM (228 KB of shared memory with 1 KB
    kept per block, 32 blocks, 64 warps), the smaller on a tie; then halved
    while the launch would have fewer blocks than the card has SMs, so that a
    small launch spreads (one member per block below ``SMS`` members). The
    members of a block share nothing; ``hermitian`` does not change the
    footprint."""
    del hermitian
    per = member_smem_bytes(n, k, n_nodes)

    def resident(mb):
        blocks = min(MAX_BLOCKS_PER_SM, SM_SHARED_BYTES // (mb * per + BLOCK_RESERVED_BYTES),
                     MAX_WARPS_PER_SM // mb)
        return blocks * mb

    fits = [mb for mb in (1, 2, 4, MAX_MEMBERS_PER_BLOCK) if mb * per <= MAX_SHARED_BYTES]
    if not fits:
        raise ValueError(
            f"the df_magnus_sweep kernel cannot fit one member of n={n}, k={k} in shared memory."
        )
    mb = max(fits, key=lambda m: (resident(m), -m))
    while mb > 1 and -(-B // mb) < SMS:
        mb //= 2
    return LaunchShape(mb, -(-B // mb), resident(mb), mb * per)


def _launch_kernel(inputs: DfInputs, chunk_b: int, rotated: Optional[bool] = None):
    """Form the tables once, then launch the sweep over chunks of ``chunk_b``
    members. ``rotated`` forces a table layout (the timing script compares
    the two); by default it follows :func:`rotated_tables`."""
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch
    if n > MAX_WIDE_N:
        raise ValueError(f"the CUDA df_magnus_sweep kernel takes n <= {MAX_WIDE_N}; got n={n}.")
    if kernel_for(n) == "wide":
        return _launch_wide(inputs, chunk_b)
    device = inputs.y0.device
    n_nodes = inputs.taus.shape[1]
    np_ = padded(n)
    if rotated is None:
        rotated = rotated_tables(n, k, n_nodes, T)
    opsp = torch.empty((k + 1, np_, np_), dtype=torch.complex128, device=device)
    tab = torch.empty((T, n_nodes, k + 1 if rotated else 1, np_, np_), dtype=torch.complex128,
                      device=device)
    out = torch.empty((n, B), dtype=torch.complex128, device=device)
    evals = torch.zeros((inputs.n_eval, n, B), dtype=torch.complex128, device=device)
    _LIB.df_magnus_sweep_tables(inputs.static, inputs.ops, inputs.omega, inputs.taus, opsp, tab,
                                n, k, T, n_nodes, int(rotated))
    for b0 in range(0, B, chunk_b):
        nb = min(chunk_b, B - b0)
        shape = launch_shape(n, k, n_nodes, inputs.hermitian, nb)
        _LIB.df_magnus_sweep_launch(
            opsp, tab, inputs.step, inputs.coef, inputs.slots, inputs.y0, out, evals, n, k, T,
            n_nodes, inputs.order, int(inputs.hermitian), int(rotated), shape.members_per_block,
            b0, nb, B,
        )
    return out, (evals if inputs.n_eval else None)


def _launch_wide(inputs: DfInputs, chunk_b: int):
    """The sweep above ``MAX_N`` (``csrc/df_magnus_wide.cu``): one block per
    member from the untabled operators, over chunks of ``chunk_b`` members."""
    n, k, T, B = inputs.n, inputs.k, inputs.steps, inputs.batch
    device = inputs.y0.device
    n_nodes = inputs.taus.shape[1]
    out = torch.empty((n, B), dtype=torch.complex128, device=device)
    evals = torch.zeros((inputs.n_eval, n, B), dtype=torch.complex128, device=device)
    for b0 in range(0, B, chunk_b):
        nb = min(chunk_b, B - b0)
        nbytes = int(_WIDE_LIB.df_magnus_wide_work_bytes(n, k, n_nodes, nb))
        if nbytes < 0:
            raise ValueError(f"the CUDA df_magnus_sweep kernel refuses n={n}, {nb} members.")
        work = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
        _WIDE_LIB.df_magnus_wide_launch(
            inputs.static, inputs.ops, inputs.omega, inputs.taus, inputs.step, inputs.coef,
            inputs.slots, inputs.y0, out, evals, work, n, k, T, n_nodes, inputs.order,
            int(inputs.hermitian), b0, nb, B,
        )
    return out, (evals if inputs.n_eval else None)


def _dmma_product(x: torch.Tensor, y: torch.Tensor, mode: int = 0) -> torch.Tensor:
    """``x @ y`` (mode 0), ``x @ y - y @ x`` (1) or ``c - c^H`` with ``c = x @
    y`` (2) for (n, n) complex128 CUDA tensors, through the kernel's FP64
    tensor-core product and transposed reads in one warp: the card tests'
    check of its fragment layout."""
    x, y = x.contiguous(), y.contiguous()
    z = torch.empty_like(x)
    _LIB.df_magnus_sweep_product(x, y, z, x.shape[0], mode)
    return z


# ---------------------------------------------------------------------------
# Plain version: the same step rules, batched over members
# ---------------------------------------------------------------------------
def _commutator(a, b, hermitian: bool):
    """[a, b] for (B, n, n) stacks; one product when both are anti-Hermitian."""
    c = a @ b
    if hermitian:
        return c - c.mH
    return c - b @ a


def magnus_operator(static, ops, omega, taus, step, coef, magnus_order: int, hermitian: bool):
    """One step's Magnus operator ``M`` (B, n, n): the generators at the node
    times ``taus`` (n_nodes,) for the coefficients ``coef`` (n_nodes, k, B),
    then the rule with the step constants ``step`` of
    :func:`~.magnus_rule.step_constants`.
    The plain version and the df32 path's adaptive grid both use it."""
    comm = lambda a, b: _commutator(a, b, hermitian)  # noqa: E731
    gens = []
    for g in range(taus.shape[0]):
        ph = torch.fmod(omega * taus[g], TWO_PI)
        phase = torch.polar(torch.ones_like(ph), ph)
        acc = static + torch.einsum("jb,jmn->bmn", coef[g].to(torch.complex128), ops)
        gens.append(phase * acc)
    if magnus_order == 2:
        return (gens[0] + gens[1]) * step[0] + comm(gens[1], gens[0]) * step[1]
    two, twenty, inv12, inv60, inv240, _ = _rule_consts(3, 1)
    a1 = gens[1] * step[0]
    a2 = (gens[2] - gens[0]) * step[1]
    a3 = ((gens[2] - gens[1]) + (gens[0] - gens[1])) * step[2]
    comm1 = comm(a1, a2)
    right = a2 + comm(two * a3 + comm1, a1) * inv60
    left = comm1 - (twenty * a1 + a3)
    return (a1 + a3 * inv12) + comm(left, right) * inv240


def sweep_expm_magnus_df_plain(inputs: DfInputs, chunk_b: int = 2048):
    """The plain version on any device: ``(final, trajectory or None)``."""
    n, T, B = inputs.n, inputs.steps, inputs.batch
    device = inputs.y0.device
    final = torch.empty((n, B), dtype=torch.complex128, device=device)
    traj = torch.zeros((max(inputs.n_eval, 1), n, B), dtype=torch.complex128, device=device)
    slots = None if inputs.slots is None else inputs.slots.tolist()
    inv = _rule_consts(inputs.magnus_order, inputs.order)[-1]
    for b0 in range(0, B, chunk_b):
        b1 = min(b0 + chunk_b, B)
        y = inputs.y0[:, b0:b1].T[:, :, None]  # (B, n, 1)
        for s in range(T):
            M = magnus_operator(inputs.static, inputs.ops, inputs.omega, inputs.taus[s],
                                inputs.step[s], inputs.coef[s, :, :, b0:b1],
                                inputs.magnus_order, inputs.hermitian)
            v = y
            for j in range(inputs.order, 0, -1):
                v = y + (M @ v) * inv[j - 1]
            y = v
            if slots is not None and slots[s] >= 0:
                traj[slots[s], :, b0:b1] = y[:, :, 0].T
        final[:, b0:b1] = y[:, :, 0].T
    return final, (traj if inputs.n_eval else None)
