r"""Batch-major eager engine for fixed-step Magnus sweeps.

Counterpart of ``qiskit_dynamics_tpu/ops/xla_sweep.py`` (the JAX package's
``sweep_engine="xla"``): the same Magnus-2 (or Magnus-3) rule and Horner
Taylor polynomial as :func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`,
written with batched ``(B, n, n)`` complex matmuls in plain PyTorch (the JAX
package leaves these to XLA outside any Pallas kernel). It serves
``fused_sweep_solve(sweep_engine="xla")`` and is the backward pass of
:mod:`~qiskit_dynamics_tpu_torch.ops.sweep_ad`.

Under autograd each step is checkpointed: only the per-step state is
stored, and the ``(B, n, n)`` generators and ``M`` are recomputed in the
backward pass instead of being kept T-fold.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..unified import default_device, to_tensor
from .magnus_rule import MAGNUS_NODES, TWO_PI, step_constants, validate_eval_slots

__all__ = ["sweep_expm_magnus2_xla"]


def sweep_expm_magnus2_xla(
    static_op, operators, frame_omega, coefficients, y0, dt, t0=0.0, order=8,
    hermitian=False, eval_slots=None, magnus_order=2,
):
    r"""Fixed-step Magnus sweep solve, batch-major eager implementation.

    Arguments and results match
    :func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`
    (``coefficients`` is ``(T, magnus_order, k, B)``: one sample per Gauss
    point; no ``tile_b`` or ``mode``). The complex dtype follows
    ``coefficients``: float64 gives complex128, anything else complex64.
    Everything is computed on the device of ``y0``, else of
    ``coefficients``, else (neither is a tensor) on the CUDA device.
    ``magnus_order`` is 2
    (4th order, 2-point Gauss) or 3 (6th order, 3-point Gauss).

    ``y0`` may also be 3d ``(B, n, m)`` batch-major: ``m`` state columns per
    member sharing one generator; outputs are then ``(B, n, m)`` (and an
    ``(n_eval, B, n, m)`` trajectory). Gradients flow to every tensor input
    that requires grad, ``frame_omega`` included.
    """
    if magnus_order not in (2, 3):
        raise ValueError(f"magnus_order must be 2 or 3, got {magnus_order!r}")
    if isinstance(y0, torch.Tensor):
        device = y0.device
    elif isinstance(coefficients, torch.Tensor):
        device = coefficients.device
    else:
        device = default_device()
    coef = to_tensor(coefficients, device=device)
    real = torch.float64 if coef.dtype == torch.float64 else torch.float32
    cplx = torch.complex128 if real == torch.float64 else torch.complex64
    coef = coef.to(real)
    static = to_tensor(static_op, device=device).to(cplx)
    ops = to_tensor(operators, device=device).to(cplx)
    omega = to_tensor(frame_omega, dtype=torch.float64, device=device)
    T = coef.shape[0]
    y = to_tensor(y0, device=device).to(cplx)
    batch_major = y.ndim == 3
    if not batch_major:
        y = y.transpose(0, 1)[..., None]  # (B, n, 1)

    n_eval = 0
    slots = None
    if eval_slots is not None:
        n_eval = validate_eval_slots(eval_slots, T)
        slots = [int(s) for s in eval_slots]

    nodes = MAGNUS_NODES[magnus_order].tolist()

    def phase(step, gauss_c):
        """(n, n) frame phase ``exp(i omega tau)``, tau = t0 + (step + c) dt,
        formed in float64 and reduced mod 2 pi."""
        ph = torch.fmod(omega * (t0 + (step + gauss_c) * dt), TWO_PI)
        return torch.exp(1j * ph).to(cplx)

    def generator(coef_g, ph):
        """(k, B) coefficients + (n, n) phase -> (B, n, n) rotated generator."""
        A = static[None] + torch.einsum("kb,kij->bij", coef_g.to(cplx), ops)
        return A * ph[None]

    def comm(A, Bm):
        """[A, B]; anti-Hermitian operands give AB = (BA)^dagger, so one
        batched matmul and a conjugate transpose replace two matmuls."""
        P = A @ Bm
        if hermitian:
            return P - P.conj().transpose(-1, -2)
        return P - Bm @ A

    def magnus_matrix(step, coef_step):
        gens = [generator(coef_step[g], phase(step, c)) for g, c in enumerate(nodes)]
        if magnus_order == 2:
            c1, c2 = step_constants(2, dt)
            G1, G2 = gens
            return c1 * (G1 + G2) + c2 * comm(G2, G1)
        G1, G2, G3 = gens
        dtf, c0dt, c1dt = step_constants(3, dt)
        a1 = dtf * G2
        a2 = c0dt * (G3 - G1)
        a3 = c1dt * (G3 - 2.0 * G2 + G1)
        C1 = comm(a1, a2)
        C2 = comm(2.0 * a3 + C1, a1) / 60.0
        return a1 + a3 / 12.0 + comm(-20.0 * a1 - a3 + C1, a2 + C2) / 240.0

    def step_fn(y, coef_step, step):
        M = magnus_matrix(step, coef_step)
        v = y
        for kk in range(order, 0, -1):
            v = y + (M @ v) / kk
        return v

    differentiable = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in (coef, static, ops, omega, y)
    )
    evals = [None] * n_eval
    for step in range(T):
        if differentiable:
            y = checkpoint(step_fn, y, coef[step], step, use_reentrant=False)
        else:
            y = step_fn(y, coef[step], step)
        if slots is not None and slots[step] >= 0:
            evals[slots[step]] = y
    if batch_major:
        return (y, torch.stack(evals)) if n_eval else y
    final = y[..., 0].transpose(0, 1)  # (n, B)
    if n_eval:
        return final, torch.stack(evals)[..., 0].transpose(1, 2)  # (n_eval, n, B)
    return final
