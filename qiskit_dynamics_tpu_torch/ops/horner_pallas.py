r"""Horner ``expm`` action on batch-major step matrices: CUDA kernel and plain
version.

Counterpart of ``qiskit_dynamics_tpu/ops/horner_pallas.py`` (the module name
is kept so a reader finds it). The polynomial engine
(:mod:`~qiskit_dynamics_tpu_torch.ops.polynomial_sweep`) applies
``y <- expm(M_b) y_b`` per step with an order-``p`` Horner recursion

.. math:: u \leftarrow v + M u / k,\qquad k = p, \dots, 1 .

Written as batched matmuls, every one of the ``p`` iterations is its own pass
over the ``(B, n, n)`` step matrices in device memory. The kernel
(``csrc/horner_apply.cu``) reads each matrix once up to ``n = 256``:
persistent thread-block clusters (1 to 8 blocks per member) walk over the
members, each keeping a member's planes in registers for all ``p``
iterations while the next member's planes stream into shared memory, and the
blocks of a cluster trade each iteration's ``u`` through distributed shared
memory. Above ``n = 256``, where eight blocks cannot hold a member in
registers, a streaming variant re-reads the matrix in every iteration (any
``n`` up to ``horner_apply_max_n()`` of the kernel library, 14,528).

Inputs are the TRANSPOSED matrices ``MT[b] = M_b^T`` as real and imaginary
planes: the caller gets the transpose for free by transposing its host-side
expansion matrices, and a thread that owns output ``i`` then reads
``MT[j, i]``, consecutive across threads.

- :func:`horner_apply_bm`: the kernel for CUDA tensors (float32; raises for
  what it cannot launch), the plain version for CPU tensors.
- :func:`horner_twin_bm`: the plain version, the same polynomial on the same
  transposed planes, in the dtype it is given (float32 or float64).
- :func:`horner_apply_bm_ad`: kernel forward, plain-version backward.

Not carried from the JAX package: ``body="loop"|"unrolled"`` (two Mosaic
compile strategies for one function), ``block_b`` (the kernel sizes its own
clusters) and ``interpret``.
"""
from __future__ import annotations

import torch

from ..kernels import Library

__all__ = ["horner_apply_bm", "horner_apply_bm_ad", "horner_twin_bm"]


def _check(MTr, MTi, vr, vi):
    B, n = vr.shape
    if not (MTr.shape == MTi.shape == (B, n, n) and vi.shape == (B, n)):
        raise ValueError(
            f"shape mismatch: MT planes {tuple(MTr.shape)}, {tuple(MTi.shape)}; state planes "
            f"{tuple(vr.shape)}, {tuple(vi.shape)}"
        )
    if not (MTr.dtype == MTi.dtype == vr.dtype == vi.dtype) or not MTr.is_floating_point():
        raise TypeError("the four planes must share one real floating dtype.")
    if not (MTr.device == MTi.device == vr.device == vi.device):
        raise ValueError("the four planes must lie on one device.")


def horner_apply_bm(MTr, MTi, vr, vi, order: int = 8):
    """Batched ``u = sum_{j<=order} M^j v / j!`` on real/imag planes.

    Args:
        MTr, MTi: ``(B, n, n)`` real/imag planes of the TRANSPOSED step
            matrices (``MT[b] = M_b^T``).
        vr, vi: ``(B, n)`` real/imag state rows.
        order: Horner Taylor order (>= 1).

    Returns:
        ``(ur, ui)``: ``(B, n)`` real/imag planes of the result. Not
        differentiable (:func:`horner_apply_bm_ad` is).
    """
    _check(MTr, MTi, vr, vi)
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if vr.is_cuda:
        return _launch_kernel(MTr.detach(), MTi.detach(), vr.detach(), vi.detach(), int(order))
    if vr.device.type == "cpu":
        with torch.no_grad():
            return horner_twin_bm(MTr, MTi, vr, vi, order=order)
    raise RuntimeError(f"horner_apply_bm has no path for device {vr.device}.")


_LIB = Library("horner_apply", {
    "horner_apply_launch": "p6 i4 s",
    "horner_apply_cluster": "i -> i",
    "horner_apply_active_clusters": "i2 -> i",
    "horner_apply_max_n": "-> i",
})


def _launch_kernel(MTr, MTi, vr, vi, order: int, force_stream: bool = False):
    """Launch the resident kernel, or the streaming one where the matrix
    cannot stay on chip (``force_stream``: always, for the tests and the
    timing scripts)."""
    B, n = vr.shape
    if MTr.dtype != torch.float32:
        raise TypeError(
            "the CUDA horner_apply kernel runs float32 only; its complex128 mode is queued "
            "(ROADMAP, left from A8)."
        )
    if n > _LIB.horner_apply_max_n():
        raise ValueError(
            f"the CUDA horner_apply kernel takes n <= {_LIB.horner_apply_max_n()} (its streaming "
            f"variant keeps two vectors of n complex entries in shared memory); got n={n}."
        )
    MTr, MTi, vr, vi = (x.contiguous() for x in (MTr, MTi, vr, vi))
    ur, ui = torch.empty_like(vr), torch.empty_like(vi)
    _LIB.horner_apply_launch(MTr, MTi, vr, vi, ur, ui, B, n, order, int(force_stream))
    return ur, ui


def horner_twin_bm(MTr, MTi, vr, vi, order: int = 8):
    """Plain version of :func:`horner_apply_bm` (the same polynomial, the same
    transposed-input contract), differentiable; the backward pass of
    :func:`horner_apply_bm_ad`."""
    MT = torch.complex(MTr, MTi)
    v = torch.complex(vr, vi)[:, None, :]  # row vectors: u @ M^T = (M u)^T
    u = v
    for k in range(order, 0, -1):
        u = v + torch.matmul(u, MT) * (1.0 / k)
    u = u[:, 0, :]
    return torch.real(u), torch.imag(u)


class _HornerApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, MTr, MTi, vr, vi, order):
        ctx.order = order
        ctx.save_for_backward(MTr, MTi, vr, vi)
        return horner_apply_bm(MTr, MTi, vr, vi, order=order)

    @staticmethod
    def backward(ctx, gr, gi):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(ctx.needs_input_grad[i])
                      for i, x in enumerate(saved)]
            outs = horner_twin_bm(*inputs, order=ctx.order)
            pairs = [(o, g) for o, g in zip(outs, (gr, gi)) if g is not None]
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True
            ))
        return (*[next(grads) if x.requires_grad else None for x in inputs], None)


def horner_apply_bm_ad(MTr, MTi, vr, vi, order: int = 8):
    """:func:`horner_apply_bm` with gradients: the backward pass differentiates
    :func:`horner_twin_bm` at the saved inputs."""
    return _HornerApply.apply(MTr, MTi, vr, vi, int(order))
