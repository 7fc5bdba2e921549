r"""Batch-minor linear algebra for large sweeps of small matrices: CUDA kernels
and plain versions.

Counterpart of ``qiskit_dynamics_tpu/ops/batched_linalg.py``. Matrices are
stored "structure of arrays" as ``(n, n, B)`` real and imaginary planes with
the sweep batch minor, so neighbouring threads read neighbouring addresses.

- :func:`matmul_bol`: ``C_b = A_b @ B_b``.
- :func:`expm_taylor_bol`: fixed-order Horner Taylor ``expm`` with static
  scaling and squaring.
- :func:`expm_taylor_bol_bwd`: its vector-Jacobian product. The recursion is
  a polynomial in X with real coefficients, so the VJP with cotangent G is
  its Frechet derivative at ``X^H`` in the direction G: the same recursion
  run forward on a pair ``(t, dt)``, with nothing stored for a reverse pass.
- :func:`expm_taylor_bol_ad`: ``expm_taylor_bol`` with gradients, kernel
  forward and kernel backward.

For CUDA tensors (float32; float64 too for :func:`expm_taylor_bol`, the
per-step ``expm`` of the FP64 Magnus Dysolve; n up to ``MAX_N``) the three
functions launch the kernels of ``csrc/batched_linalg.cu`` (up to n = 16 the
expm and its backward give a thread one column of a lane's matrix; above, a
thread owns a tile and the three share one product routine); for CPU
tensors they run the plain versions
(:func:`matmul_bol_plain`, :func:`expm_taylor_bol_plain`,
:func:`expm_taylor_bol_bwd_plain`) in the dtype they are given. The kernels
fuse multiply-adds, so they agree with the plain versions to float32
roundoff, not bit for bit.

Planes may be contiguous or the ``real``/``imag`` views of one contiguous
complex tensor (element stride 2): the kernels take either without a copy,
and return the ``real``/``imag`` views of one complex64 (complex128) tensor.

Not carried from the JAX package: ``tile_b`` (the kernels mask their own
last block, so callers pad nothing) and ``interpret``. :func:`launch_shape`
reports the launch a kernel takes on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import Library

__all__ = [
    "matmul_bol",
    "matmul_bol_plain",
    "expm_taylor_bol",
    "expm_taylor_bol_plain",
    "expm_taylor_bol_ad",
    "expm_taylor_bol_bwd",
    "expm_taylor_bol_bwd_plain",
    "launch_shape",
    "to_bol",
    "from_bol",
]

# the kernels keep a lane's matrices in shared memory while they fit a block's
# 227 KB (n <= 98 for the product and the expm), in a device work buffer above
MAX_N = 256


def to_bol(A):
    """(B, n, n) complex -> ((n, n, B) real, (n, n, B) imag)."""
    A = torch.movedim(A, 0, -1)
    return torch.real(A), torch.imag(A)


def from_bol(Ar, Ai):
    """((n, n, B), (n, n, B)) -> (B, n, n) complex."""
    return torch.movedim(torch.complex(Ar, Ai), -1, 0)


def _check(*planes):
    first = planes[0]
    if first.ndim != 3 or first.shape[0] != first.shape[1]:
        raise ValueError(f"planes must be (n, n, B); got {tuple(first.shape)}")
    for p in planes[1:]:
        if p.shape != first.shape:
            raise ValueError(
                f"shape mismatch: planes {tuple(first.shape)} and {tuple(p.shape)}"
            )
        if p.dtype != first.dtype or p.device != first.device:
            raise TypeError("the planes must share one real floating dtype and one device.")
    if not first.is_floating_point():
        raise TypeError("the planes must share one real floating dtype and one device.")


def _check_expm(order: int, squarings: int):
    if order < 1 or squarings < 0:
        raise ValueError(f"order must be >= 1 and squarings >= 0; got {order}, {squarings}")


def _route(name: str, first, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if first.is_cuda:
        return kernel()
    if first.device.type == "cpu":
        with torch.no_grad():
            return plain()
    raise RuntimeError(f"{name} has no path for device {first.device}.")


# --------------------------------------------------------------------------
# public functions
# --------------------------------------------------------------------------
def matmul_bol(Ar, Ai, Br, Bi):
    """Batched complex matmul on (n, n, B) real/imag planes: returns
    ``(Cr, Ci)`` with ``C_b = A_b @ B_b``."""
    _check(Ar, Ai, Br, Bi)
    return _route(
        "matmul_bol", Ar,
        lambda: _launch_kernel("matmul", (Ar, Ai, Br, Bi)),
        lambda: matmul_bol_plain(Ar, Ai, Br, Bi),
    )


def expm_taylor_bol(Xr, Xi, order: int = 8, squarings: int = 0):
    """Batched complex ``expm`` on (n, n, B) real/imag planes: scale by
    ``2^-squarings``, Horner Taylor of fixed ``order``, ``squarings``
    squarings. Returns ``(Pr, Pi)``. Not differentiable
    (:func:`expm_taylor_bol_ad` is)."""
    _check(Xr, Xi)
    _check_expm(order, squarings)
    return _route(
        "expm_taylor_bol", Xr,
        lambda: _launch_kernel("expm", (Xr, Xi), int(order), int(squarings)),
        lambda: expm_taylor_bol_plain(Xr, Xi, order, squarings),
    )


def expm_taylor_bol_bwd(Xr, Xi, CTr, CTi, order: int = 8, squarings: int = 0):
    """VJP of :func:`expm_taylor_bol`: the cotangents ``(GXr, GXi)`` of the
    input planes for output cotangents ``(CTr, CTi)``."""
    _check(Xr, Xi, CTr, CTi)
    _check_expm(order, squarings)
    return _route(
        "expm_taylor_bol_bwd", Xr,
        lambda: _launch_kernel("expm_bwd", (Xr, Xi, CTr, CTi), int(order), int(squarings)),
        lambda: expm_taylor_bol_bwd_plain(Xr, Xi, CTr, CTi, order, squarings),
    )


_KINDS = {"matmul": 0, "expm": 1, "expm_bwd": 2}  # the library's kind of each kernel


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
_LIB = Library("batched_linalg", {
    "matmul_bol_launch": "p6 i4 p s",
    "expm_bol_launch": "p4 i6 p s",
    "expm_bwd_bol_launch": "p7 i6 s",
    "batched_linalg_work_bytes": "i6 -> q",
    "batched_linalg_shape": "i4 p -> i",
})


@dataclass(frozen=True)
class LaunchShape:
    """The launch of one kernel: lanes per block, threads per lane, threads
    and blocks, dynamic shared bytes, whether it takes a lane kernel (n <= 16:
    a thread per column, a lane's threads in one warp), whether a lane's
    matrices sit in device memory, whether threads loop over tiles (wide),
    and the blocks the card keeps resident on one SM."""

    lanes_per_block: int
    threads_per_lane: int
    threads: int
    blocks: int
    smem_bytes: int
    lane_kernel: bool
    in_device: bool
    wide: bool
    blocks_per_sm: int

    @property
    def warps_per_sm(self) -> int:
        return self.blocks_per_sm * -(-self.threads // 32)


def launch_shape(which: str, n: int, lanes: int, double: bool = False) -> LaunchShape:
    """The launch ``which`` ("matmul", "expm" or "expm_bwd") takes on the
    current CUDA device for ``lanes`` lanes of n x n matrices (``double``:
    the complex128 expm). Needs the card: it builds and asks the library."""
    out = torch.zeros(9, dtype=torch.int64)
    code = _LIB.batched_linalg_shape(_KINDS[which], n, lanes, int(double), out)
    if code != 0:
        raise ValueError(f"the CUDA batched_linalg {which} kernel refuses n={n}, "
                         f"{lanes} lanes (error code {code}).")
    v = out.tolist()
    return LaunchShape(*v[:5], *(bool(x) for x in v[5:8]), v[8])


def _element_stride(plane) -> int:
    """1 for a contiguous (n, n, B) plane, 2 for the real or imaginary view of
    a contiguous complex tensor, 0 for anything else."""
    n, _, B = plane.shape
    for es in (1, 2):
        if plane.stride() == (n * B * es, B * es, es):
            return es
    return 0


def _pair(pr, pi):
    """A real/imag pair the kernels can read in place, and its element
    stride; anything else is copied to contiguous planes first."""
    es = _element_stride(pr)
    if es == 0 or _element_stride(pi) != es:
        return pr.contiguous(), pi.contiguous(), 1
    return pr, pi, es


def _launch_kernel(which: str, planes, order: int = 0, squarings: int = 0):
    first = planes[0]
    n, _, B = first.shape
    double = first.dtype == torch.float64
    if not (first.dtype == torch.float32 or (double and which == "expm")):
        raise TypeError(
            f"the CUDA batched_linalg {which} kernel runs float32 only (float64 is the expm's "
            "alone, for the FP64 Magnus Dysolve, which has no gradient); got "
            f"{first.dtype}."
        )
    if n > MAX_N:
        raise ValueError(f"the CUDA batched_linalg kernels take n <= {MAX_N}; got n={n}.")
    out = torch.empty((n, n, B), dtype=torch.complex128 if double else torch.complex64,
                      device=first.device)
    out_planes = torch.view_as_real(out)
    if B == 0:
        return out_planes[..., 0], out_planes[..., 1]
    pairs = [_pair(planes[i].detach(), planes[i + 1].detach()) for i in range(0, len(planes), 2)]
    inputs = [x for pair in pairs for x in pair[:2]]
    strides = [pair[2] for pair in pairs]
    outr, outi = out_planes[..., 0], out_planes[..., 1]
    # the device work buffer: the working matrices where they do not fit
    # shared memory (none for the lane kernels)
    nbytes = int(_LIB.batched_linalg_work_bytes(_KINDS[which], n, B, order, squarings,
                                                int(double)))
    if nbytes < 0:
        raise ValueError(f"the CUDA batched_linalg {which} kernel refuses n={n}, B={B}.")
    work = torch.empty(nbytes, dtype=torch.uint8, device=first.device) if nbytes else None
    if which == "matmul":
        _LIB.matmul_bol_launch(*inputs, outr, outi, n, B, *strides, work)
    elif which == "expm":
        _LIB.expm_bol_launch(*inputs, outr, outi, n, B, order, squarings, *strides, int(double),
                             work)
    else:
        _LIB.expm_bwd_bol_launch(*inputs, outr, outi, work, n, B, order, squarings, *strides)
    return outr, outi


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _cmm(a, b):
    """Per-lane complex product of (n, n, B) stacks."""
    return torch.einsum("imb,mjb->ijb", a, b)


def matmul_bol_plain(Ar, Ai, Br, Bi):
    """Plain version of :func:`matmul_bol`."""
    C = _cmm(torch.complex(Ar, Ai), torch.complex(Br, Bi))
    return torch.real(C), torch.imag(C)


def expm_taylor_bol_plain(Xr, Xi, order: int = 8, squarings: int = 0):
    """Plain version of :func:`expm_taylor_bol`: the same recursion
    (``t <- I + s t / k`` for ``k = order - 1 .. 1`` from ``t = I + s / order``,
    then the squarings) in eager torch, differentiable."""
    n = Xr.shape[0]
    s = torch.complex(Xr, Xi) * (1.0 / (2.0**squarings))
    eye = torch.eye(n, dtype=s.dtype, device=s.device)[:, :, None]
    t = s / order + eye
    for k in range(order - 1, 0, -1):
        t = _cmm(s, t) * (1.0 / k) + eye
    for _ in range(squarings):
        t = _cmm(t, t)
    return torch.real(t), torch.imag(t)


def expm_taylor_bol_bwd_plain(Xr, Xi, CTr, CTi, order: int = 8, squarings: int = 0):
    """Plain version of :func:`expm_taylor_bol_bwd`, the kernels' arithmetic
    in eager torch: the Frechet derivative of the recursion at ``X^H`` in the
    direction ``G = CTr + i CTi``, run forward on the pair ``(t, dt)`` with
    the scale ``2^-squarings`` kept in the coefficients: ``t = I + c X^H``,
    ``dt = c G`` with ``c = 2^-q / order``; per Horner stage
    ``(t, dt) <- (I + c X^H t, c (G t + X^H dt))`` with ``c = 2^-q / k``; per
    squaring ``(t, dt) <- (t t, t dt + dt t)``. Returns ``(Re dt, Im dt)``."""
    n = Xr.shape[0]
    scale = 1.0 / (2.0**squarings)
    xh = torch.complex(Xr, -Xi).transpose(0, 1)
    g = torch.complex(CTr, CTi)
    eye = torch.eye(n, dtype=xh.dtype, device=xh.device)[:, :, None]
    t = xh * (scale / order) + eye
    dt = g * (scale / order)
    for k in range(order - 1, 0, -1):
        c = scale / k
        t, dt = _cmm(xh, t) * c + eye, (_cmm(g, t) + _cmm(xh, dt)) * c
    for _ in range(squarings):
        t, dt = _cmm(t, t), _cmm(t, dt) + _cmm(dt, t)
    return torch.real(dt), torch.imag(dt)


# --------------------------------------------------------------------------
# the differentiable wrapper
# --------------------------------------------------------------------------
class _ExpmTaylorBol(torch.autograd.Function):
    """Forward :func:`expm_taylor_bol`, backward :func:`expm_taylor_bol_bwd`:
    a kernel in both directions on the card."""

    @staticmethod
    def forward(ctx, Xr, Xi, order, squarings):
        ctx.order, ctx.squarings = order, squarings
        ctx.save_for_backward(Xr, Xi)
        return expm_taylor_bol(Xr, Xi, order, squarings)

    @staticmethod
    def backward(ctx, ct_r, ct_i):
        Xr, Xi = ctx.saved_tensors
        ct_r = torch.zeros_like(Xr) if ct_r is None else ct_r
        ct_i = torch.zeros_like(Xi) if ct_i is None else ct_i
        gr, gi = expm_taylor_bol_bwd(Xr, Xi, ct_r, ct_i, ctx.order, ctx.squarings)
        return gr, gi, None, None


def expm_taylor_bol_ad(Xr, Xi, order: int = 8, squarings: int = 0):
    """Differentiable :func:`expm_taylor_bol`. This is what makes
    ``MagnusSolver.solve_sweep`` differentiable end to end (the per-step
    propagator is ``Udt @ expm(polynomial)``)."""
    _check(Xr, Xi)
    _check_expm(order, squarings)
    return _ExpmTaylorBol.apply(Xr, Xi, int(order), int(squarings))
