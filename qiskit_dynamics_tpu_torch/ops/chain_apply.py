r"""Streamed propagator-chain application: CUDA kernel and plain version.

Counterpart of ``qiskit_dynamics_tpu/ops/chain_apply.py``. Applies a sequence
of per-step, per-lane propagators to a state:
``y_b <- U_{T-1,b} ... U_{1,b} U_{0,b} y_b`` for every lane ``b``.

The propagator stack is ``(T, n, n, B)`` complex with the sweep batch minor.
The kernel (``csrc/chain_apply.cu``) reads every propagator entry once,
straight from the complex64 or complex128 tensor it is given (any strides over the first
three axes, so the ``(n, n, T, B)`` product of a matmul needs no copy), and
keeps a lane's state in shared memory for the whole time loop. One launch
replaces ``T`` sequential batched mat-vecs.

- :func:`chain_apply_bol`: the kernel for CUDA tensors (complex64, or
  complex128 for the FP64 Dysolve; raises for what it cannot launch), the
  plain version for CPU tensors.
- :func:`chain_apply_bol_plain`: the kernel's arithmetic on real and
  imaginary planes, in the same order (the kernel is built without
  multiply-add contraction, so the two agree bit for bit), in the dtype it is
  given.
- :func:`chain_apply_bol_ad`: kernel forward, eager backward.

Not carried from the JAX package: ``tile_b`` (the kernel masks its own last
block, so callers pad nothing) and ``interpret``.
"""
from __future__ import annotations

import torch

from ..kernels import Library

__all__ = ["chain_apply_bol", "chain_apply_bol_ad", "chain_apply_bol_plain"]

MAX_N = 4096  # the kernel's cap on the state dimension (rows i, i + 32, ... per thread above 32)


def _check(props, y0):
    if props.ndim != 4 or props.shape[1] != props.shape[2]:
        raise ValueError(f"props must be (T, n, n, B); got {tuple(props.shape)}")
    T, n, _, B = props.shape
    if T == 0:
        raise ValueError("chain_apply_bol requires at least one propagator (T >= 1).")
    if y0.shape != (n, B):
        raise ValueError(f"y0 must be (n, B) = {(n, B)}; got {tuple(y0.shape)}")
    if not (props.is_complex() and y0.is_complex()):
        raise TypeError("props and y0 must be complex.")
    if props.device != y0.device:
        raise ValueError("props and y0 must lie on one device.")


def chain_apply_bol(props, y0):
    """Apply a per-lane propagator chain to a state.

    Args:
        props: (T, n, n, B) complex per-step propagators (step 0 first).
        y0: (n, B) complex initial states.

    Returns:
        (n, B) complex final states. Not differentiable
        (:func:`chain_apply_bol_ad` is).
    """
    _check(props, y0)
    if props.is_cuda:
        return _launch_kernel(props.detach(), y0.detach())
    if props.device.type == "cpu":
        with torch.no_grad():
            return chain_apply_bol_plain(props, y0.to(props.dtype))
    raise RuntimeError(f"chain_apply_bol has no path for device {props.device}.")


_LIB = Library("chain_apply", {"chain_apply_launch": "p3 i3 q3 i s"})


def _launch_kernel(props, y0):
    T, n, _, B = props.shape
    if props.dtype not in (torch.complex64, torch.complex128) or y0.dtype != props.dtype:
        raise TypeError(
            "the CUDA chain_apply kernel runs complex64 or complex128, props and y0 of one "
            f"type; got {props.dtype} and {y0.dtype}."
        )
    if n > MAX_N:
        raise ValueError(f"the CUDA chain_apply kernel takes n <= {MAX_N}; got n={n}.")
    if B > 1 and props.stride(3) != 1:
        props = props.contiguous()  # the kernel needs the batch minor
    y0 = y0.contiguous()
    out = torch.empty_like(y0)
    _LIB.chain_apply_launch(props, y0, out, T, n, B, *props.stride()[:3],
                            int(props.dtype == torch.complex128))
    return out


def chain_apply_bol_plain(props, y0):
    """Plain version of :func:`chain_apply_bol`: per step and row,
    ``acc += ur * yr - ui * yi`` and ``acc += ur * yi + ui * yr`` over the
    columns in order, on real and imaginary planes, as the kernel does."""
    T, n = props.shape[0], props.shape[1]
    ur_all, ui_all = torch.real(props), torch.imag(props)
    yr, yi = torch.real(y0), torch.imag(y0)
    for t in range(T):
        ur, ui = ur_all[t], ui_all[t]
        acc_r = torch.zeros_like(yr)
        acc_i = torch.zeros_like(yi)
        for m in range(n):
            acc_r = acc_r + (ur[:, m] * yr[m] - ui[:, m] * yi[m])
            acc_i = acc_i + (ur[:, m] * yi[m] + ui[:, m] * yr[m])
        yr, yi = acc_r, acc_i
    return torch.complex(yr, yi)


def _chain_states(props, y0):
    """The states before every step, ``(T, n, B)``, by one broadcast multiply
    and one sum per step (the backward pass's recompute)."""
    states = torch.empty((props.shape[0],) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    states[0] = y0
    rows = states.unsqueeze(1).unbind(0)  # (1, n, B) each: broadcast over the output row
    for u, y, y_next in zip(props.unbind(0)[:-1], rows, states.unbind(0)[1:]):
        torch.sum(u * y, dim=1, out=y_next)
    return states


class _ChainApply(torch.autograd.Function):
    """Kernel forward; eager backward by the reverse recurrence
    ``lambda_t = U_t^H lambda_{t+1}``, ``dU_t = lambda_{t+1} y_t^H``. Only the
    ``(T, n, B)`` states are recomputed and kept, never per-step ``(n, n, B)``
    intermediates of an autograd tape."""

    @staticmethod
    def forward(ctx, props, y0):
        ctx.save_for_backward(props, y0)
        return chain_apply_bol(props, y0)

    @staticmethod
    def backward(ctx, grad):
        props, y0 = ctx.saved_tensors
        need_props, need_y0 = ctx.needs_input_grad
        # few, plain launches per step and views made once: on the card this
        # loop is bound by the host's launch rate, not by the device
        with torch.no_grad():
            states_conj = _chain_states(props, y0.to(props.dtype)).conj_physical_()
            props_conj = props.conj().resolve_conj().unbind(0)
            lam = grad.to(props.dtype)
            grad_props = torch.empty(
                tuple(props.shape), dtype=props.dtype, device=props.device
            ) if need_props else None
            outs = grad_props.unbind(0) if need_props else [None] * props.shape[0]
            columns = states_conj.unsqueeze(1).unbind(0)  # (1, n, B) each
            for t in range(props.shape[0] - 1, -1, -1):
                lam_rows = lam.unsqueeze(1)  # (n, 1, B)
                if need_props:
                    torch.mul(lam_rows, columns[t], out=outs[t])
                lam = torch.sum(props_conj[t] * lam_rows, dim=0)
        return grad_props, (lam.to(y0.dtype) if need_y0 else None)


def chain_apply_bol_ad(props, y0):
    """:func:`chain_apply_bol` with gradients in ``props`` and ``y0``: the
    streamed kernel forward, the eager reverse recurrence backward."""
    _check(props, y0)
    return _ChainApply.apply(props, y0.to(props.dtype))
