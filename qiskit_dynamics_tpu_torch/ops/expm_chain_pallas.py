r"""Fused expm-propagator chain ``y <- expm(G_t dt) @ y``: CUDA kernel and plain
version.

Counterpart of ``qiskit_dynamics_tpu/ops/expm_chain_pallas.py`` (kernel B9).
Over ``T`` steps of ``b`` independent batch elements, each step forms
``expm(G_t dt)`` by the Taylor polynomial of
:func:`~qiskit_dynamics_tpu_torch.ops.expm.expm_taylor` (Paterson-Stockmeyer
at order >= 6, then the squarings) and applies it to the ``(n, m)`` state.

- :func:`expm_chain_fused`: the kernel (``csrc/expm_chain.cu``) for CUDA
  tensors, complex64 or complex128, one launch for the whole chain; the plain
  version for CPU tensors.
- :func:`expm_chain_fused_plain`: ``y <- expm_taylor(G_t dt) @ y`` step by
  step in eager torch, in the dtype it is given. The kernel sums its products
  in its own order with fused multiply-adds, so the two agree to roundoff.

Not carried from the JAX package: ``block_b`` (a Mosaic knob: the kernel
sizes its own groups of blocks) and ``interpret``.
"""
from __future__ import annotations

import torch

from ..kernels import Library
from .expm import expm_taylor

__all__ = ["expm_chain_fused", "expm_chain_fused_plain"]

MAX_ORDER = 40  # the kernel's table of Taylor coefficients


def _batched(generators, y0):
    """(T, b, n, n) and (b, n, m) views of the inputs, and whether they were
    unbatched ((T, n, n) and (n, m))."""
    unbatched = generators.ndim == 3
    if unbatched:
        generators, y0 = generators[:, None], y0[None]
    if (
        generators.ndim != 4 or y0.ndim != 3 or generators.shape[-1] != generators.shape[-2]
        or y0.shape[:2] != (generators.shape[1], generators.shape[2])
    ):
        raise ValueError(
            "expected generators (T, b, n, n) with y0 (b, n, m) (or unbatched (T, n, n) with "
            f"(n, m)); got {tuple(generators.shape)} / {tuple(y0.shape)}."
        )
    if generators.shape[0] < 1:
        raise ValueError("expm_chain_fused needs at least one step (T >= 1).")
    return generators, y0, unbatched


def _check_order(order: int, squarings: int):
    if order < 6:
        raise ValueError("expm_chain_fused requires order >= 6.")
    if squarings < 0:
        raise ValueError(f"squarings must be >= 0; got {squarings}.")


def expm_chain_fused(generators, dt: float, y0, order: int = 12, squarings: int = 2):
    """Fused expm-propagator chain ``y <- expm(G_t dt) @ y`` over the steps.

    Args:
        generators: ``(T, b, n, n)`` or ``(T, n, n)`` complex per-step
            generators (a tensor).
        dt: step size.
        y0: ``(b, n, m)`` / ``(n, m)`` states or propagators matching
            ``generators``' batching, on the same device.
        order: Taylor order (>= 6).
        squarings: static scaling-and-squaring steps.

    Returns:
        ``(b, n, m)`` / ``(n, m)`` final states. Not differentiable.
    """
    _check_order(order, squarings)
    if not (isinstance(generators, torch.Tensor) and isinstance(y0, torch.Tensor)):
        raise TypeError("expm_chain_fused takes tensors (their device chooses the path).")
    gens, y, unbatched = _batched(generators, y0)
    if gens.device != y.device:
        raise ValueError("generators and y0 must lie on one device.")
    if gens.is_cuda:
        out = _launch_kernel(gens.detach(), y.detach(), float(dt), int(order), int(squarings))
    elif gens.device.type == "cpu":
        with torch.no_grad():
            out = expm_chain_fused_plain(gens, dt, y, order, squarings)
    else:
        raise RuntimeError(f"expm_chain_fused has no path for device {gens.device}.")
    return out[0] if unbatched else out


def expm_chain_fused_plain(generators, dt: float, y0, order: int = 12, squarings: int = 2):
    """Plain version of :func:`expm_chain_fused`: per step
    ``y <- expm_taylor(G_t dt, order, squarings) @ y`` in eager torch (the
    same polynomial as the kernel, its products by ``torch.matmul``), in the
    dtype and on the device of the inputs."""
    _check_order(order, squarings)
    gens, y, unbatched = _batched(generators, y0)
    y = y.to(gens.dtype)
    for g in gens:
        y = expm_taylor(g * dt, order=order, squarings=squarings) @ y
    return y[0] if unbatched else y


_LIB = Library("expm_chain", {
    "expm_chain_plan": "i3 p3",
    "expm_chain_scratch_entries": "i3 -> q",
    "expm_chain_launch": "p5 i6 d i4 s",
})


def _launch_kernel(gens, y0, dt: float, order: int, squarings: int):
    T, b, n, _ = gens.shape
    m = y0.shape[-1]
    if gens.dtype not in (torch.complex64, torch.complex128) or y0.dtype != gens.dtype:
        raise TypeError(
            "the CUDA expm_chain kernel runs complex64 or complex128, generators and y0 of one "
            f"type; got {gens.dtype} and {y0.dtype}."
        )
    if order > MAX_ORDER:
        raise ValueError(f"the CUDA expm_chain kernel takes order <= {MAX_ORDER}; got {order}.")
    gens, y0 = gens.contiguous(), y0.contiguous()
    double = int(gens.dtype == torch.complex128)
    out = torch.empty_like(y0)
    plan = torch.zeros(3, dtype=torch.int32)  # group size, grid columns, groups
    with torch.cuda.device(gens.device):  # the plan is the device's
        _LIB.expm_chain_plan(n, b, double, *plan.split(1))
    group_size, grid_cols, groups = plan.tolist()
    groups = min(b, groups)
    scratch = torch.empty(groups * int(_LIB.expm_chain_scratch_entries(n, m, order)),
                          dtype=gens.dtype, device=gens.device)
    barriers = torch.zeros(groups, dtype=torch.int32, device=gens.device)
    _LIB.expm_chain_launch(gens, y0, out, scratch, barriers, T, b, n, m, order, squarings, dt,
                           group_size, grid_cols, groups, double)
    return out
