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

import ctypes

import torch

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


# the number of times the CUDA kernel was launched (reset by callers that count)
expm_chain_fused.launches = 0


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


def _kernel_lib():
    from ..kernels import _build

    lib = _build.load("expm_chain")
    pointer, integer = ctypes.c_void_p, ctypes.c_int
    lib.expm_chain_plan.argtypes = [integer] * 3 + [ctypes.POINTER(integer)] * 3
    lib.expm_chain_scratch_entries.argtypes = [integer] * 3
    lib.expm_chain_scratch_entries.restype = ctypes.c_longlong
    lib.expm_chain_launch.argtypes = (
        [pointer] * 5 + [integer] * 6 + [ctypes.c_double] + [integer] * 4 + [pointer]
    )
    for fn in (lib.expm_chain_plan, lib.expm_chain_launch):
        fn.restype = integer
    lib.expm_chain_error_string.argtypes = [integer]
    lib.expm_chain_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(
            f"expm_chain {what} failed: {lib.expm_chain_error_string(code).decode()}"
        )


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
    lib = _kernel_lib()
    out = torch.empty_like(y0)
    with torch.cuda.device(gens.device):
        group_size, grid_cols, groups = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        _raise_on(lib, lib.expm_chain_plan(n, b, double, ctypes.byref(group_size),
                                           ctypes.byref(grid_cols), ctypes.byref(groups)),
                  "launch plan")
        groups = min(b, groups.value)
        scratch = torch.empty(groups * int(lib.expm_chain_scratch_entries(n, m, order)),
                              dtype=gens.dtype, device=gens.device)
        barriers = torch.zeros(groups, dtype=torch.int32, device=gens.device)
        stream = torch.cuda.current_stream(gens.device).cuda_stream
        code = lib.expm_chain_launch(
            gens.data_ptr(), y0.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            barriers.data_ptr(), T, b, n, m, order, squarings, dt, group_size.value,
            grid_cols.value, groups, double, stream,
        )
    _raise_on(lib, code, "kernel launch")
    expm_chain_fused.launches += 1
    return out
