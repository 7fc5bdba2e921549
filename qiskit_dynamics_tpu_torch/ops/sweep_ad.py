r"""Differentiable fixed-step sweep: kernel forward, eager-engine backward.

Counterpart of ``sweep_expm_magnus2_ad`` and ``sweep_expm_magnus2_member_ad``
in ``qiskit_dynamics_tpu/ops/sweep_ad.py``. The JAX package pairs its Pallas
primal with a plain-XLA adjoint; the port keeps that pairing:

- **forward**: :func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`
  or :func:`~qiskit_dynamics_tpu_torch.ops.member_sweep.sweep_expm_magnus2_member`
  (the CUDA kernel for CUDA tensors, the plain version on the CPU);
- **backward**: a vector-Jacobian product through the eager engine
  (:mod:`~qiskit_dynamics_tpu_torch.ops.xla_sweep`, checkpointed per step),
  re-run at the saved inputs. It computes the same Magnus (order 2 or 3) and
  Horner polynomial, including the ``eval_slots`` trajectory stores, so
  trajectory gradients flow too. Neither kernel has a backward kernel, as in
  the JAX package.

Gradients reach every input that requires grad: ``coefficients``, ``y0``,
``static_op``, ``operators`` and ``frame_omega`` (through the float64 frame
phases of the eager engine), as in the JAX package.
"""
from __future__ import annotations

import torch

from .member_sweep import sweep_expm_magnus2_member
from .sweep_solver import sweep_expm_magnus2
from .xla_sweep import sweep_expm_magnus2_xla

__all__ = ["sweep_expm_magnus2_ad", "sweep_expm_magnus2_member_ad"]


def _eager_vjp(ctx, cotangents, eval_slots, **engine_kwargs):
    """Gradients of the saved (static_op, operators, frame_omega, coefficients,
    y0) through the eager engine run with ``engine_kwargs``; ``None`` for the
    inputs that need no gradient."""
    wants = ctx.needs_input_grad
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(wants[i]) for i, x in enumerate(ctx.saved_tensors)]
        out = sweep_expm_magnus2_xla(*inputs, eval_slots=eval_slots, **engine_kwargs)
        outs = out if eval_slots is not None else (out,)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True
        ))
    return [next(grads) if x.requires_grad else None for x in inputs]


class _SweepMagnus2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static_op, operators, frame_omega, coefficients, y0, statics):
        dt, t0, order, hermitian, mode, tile_b, eval_slots = statics
        ctx.statics = statics
        ctx.save_for_backward(static_op, operators, frame_omega, coefficients, y0)
        out = sweep_expm_magnus2(
            static_op, operators, frame_omega, coefficients, y0, dt=dt, t0=t0, order=order,
            tile_b=tile_b, hermitian=hermitian, mode=mode, eval_slots=eval_slots,
        )
        return out if eval_slots is not None else (out,)

    @staticmethod
    def backward(ctx, *cotangents):
        dt, t0, order, hermitian, _, _, eval_slots = ctx.statics
        result = _eager_vjp(ctx, cotangents, eval_slots, dt=dt, t0=t0, order=order,
                            hermitian=hermitian)
        return (*result, None)


class _SweepMagnus2Member(torch.autograd.Function):
    @staticmethod
    def forward(ctx, static_op, operators, frame_omega, coefficients, y0, statics):
        dt, t0, order, hermitian, magnus = statics
        ctx.statics = statics
        ctx.save_for_backward(static_op, operators, frame_omega, coefficients, y0)
        return sweep_expm_magnus2_member(
            static_op, operators, frame_omega, coefficients, y0, dt=dt, t0=t0, order=order,
            hermitian=hermitian, magnus=magnus,
        )

    @staticmethod
    def backward(ctx, cotangent):
        dt, t0, order, hermitian, magnus = ctx.statics
        result = _eager_vjp(ctx, (cotangent,), None, dt=dt, t0=t0, order=order,
                            hermitian=hermitian, magnus_order=magnus)
        return (*result, None)


def sweep_expm_magnus2_ad(
    static_op, operators, frame_omega, coefficients, y0, dt, t0, order, hermitian, mode,
    tile_b, eval_slots=None,
):
    """:func:`~qiskit_dynamics_tpu_torch.ops.sweep_solver.sweep_expm_magnus2`
    with gradients (arguments as there, all tensors on one device). The
    backward pass runs the eager engine in the dtype of ``coefficients``."""
    statics = (float(dt), float(t0), int(order), bool(hermitian), mode, int(tile_b),
               None if eval_slots is None else tuple(int(s) for s in eval_slots))
    out = _SweepMagnus2.apply(static_op, operators, frame_omega, coefficients, y0, statics)
    return out if eval_slots is not None else out[0]


def sweep_expm_magnus2_member_ad(
    static_op, operators, frame_omega, coefficients, y0, dt, t0, order, hermitian, magnus=2,
):
    """:func:`~qiskit_dynamics_tpu_torch.ops.member_sweep.sweep_expm_magnus2_member`
    with gradients (arguments as there, all tensors on one device): the
    member-major kernel forward, the eager engine at the same ``magnus`` order
    backward."""
    statics = (float(dt), float(t0), int(order), bool(hermitian), int(magnus))
    return _SweepMagnus2Member.apply(static_op, operators, frame_omega, coefficients, y0, statics)
