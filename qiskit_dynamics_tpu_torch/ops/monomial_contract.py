r"""The perturbative step's monomials and their contraction (kernel B11): CUDA
kernel and plain version.

The Dyson and Magnus ``solve_sweep`` evaluates its expansion
:math:`f(c) = A_\emptyset + \sum_k c_{I_k} A_k` at every lane (one step of
one sweep member), with ``c`` the lane's Chebyshev coefficients. The
expansion is held as one real ``(2 n^2, M)`` matrix ``planes`` (rows the real
plane, then the imaginary plane) and the constant term as a ``(2 n^2, 1)``
column ``start`` (or None): :class:`Expansion`.

- :func:`contract_monomials`: for a float32 CUDA table the kernel
  (``csrc/monomial_contract.cu``), which forms every monomial on chip and
  contracts it in FP32 without writing the table to device memory; its
  gradient is the VJP of the plain version, recomputed from the saved
  coefficient table. For anything else (CPU tensors; float64, the FP64
  Dysolve) the plain version.
- :func:`contract_monomials_plain`: ``ArrayPolynomial.compute_monomials``
  and one real product (``addmm`` with the constant term).

Both give the Dyson step propagators as complex64 (n, n, L) (``interleaved``,
what the chain B5 reads) or the Magnus exponents as real (2, n, n, L) planes
(what the Taylor expm B6 reads). The kernel's monomials are the plain
version's bit for bit (the same products in the same order); its sums run in
FP32 fused multiply-adds in term order, so the outputs agree with the plain
version's cuBLAS product to float32 roundoff.

:func:`launch_shape` and :func:`plan` (pure) pick the kernel's launch from n
and the shared memory its table needs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import MAX_SHARED_BYTES, Library

__all__ = [
    "Expansion",
    "contract_monomials",
    "contract_monomials_plain",
    "launch_shape",
    "plan",
]

LANES = 128  # lanes of a lane tile
CHUNKS = (64, 32)  # the most terms a chunk of coefficients in shared memory, first choice first
# the most warps of a block at each count of entries a thread
# (csrc/monomial_contract.cu: MaxWarps)
MAX_WARPS = {2: 32, 4: 20, 8: 14, 10: 12}
# time per entry and term relative to TE = 10, as measured on an H100 at the
# Dyson cell's shape (n = 10, 209 terms): a thread's 8 TE multiply-adds a term
# beside one shared load of its monomials and TE / 2 broadcast loads of its
# coefficients, fewer loads a multiply-add the larger TE
_PACE = {2: 1.35, 4: 1.3, 8: 1.1, 10: 1.0}
_FORMING = 3  # forming a tile's monomials, in entries' worth of multiply-adds


@dataclass(frozen=True)
class LaunchShape:
    """The kernel's launch: ``te`` entries (of both planes) a thread, ``warps``
    warps a block (``warps * te`` entries a tile), ``tiles`` tiles of entries
    (the grid's second axis)."""

    te: int
    warps: int
    tiles: int

    @property
    def entries_per_tile(self) -> int:
        return self.warps * self.te

    @property
    def threads(self) -> int:
        return 32 * self.warps

    def smem_bytes(self, n_nodes: int, n_vars: int, chunk: int) -> int:
        """A block's dynamic shared memory (``csrc/monomial_contract.cu``:
        ``smem_bytes``): with ``n_nodes`` > 0 every node's monomials at a lane
        tile, two tiles of the ``n_vars`` variables and the node table, else
        one chunk of monomials; two chunks of ``chunk`` terms' coefficients."""
        mono = (n_nodes if n_nodes > 0 else chunk) * LANES
        slabs = 2 * n_vars * LANES if n_nodes > 0 else 0
        return 4 * (mono + 2 * self.warps * chunk * 2 * self.te + slabs + 4 * n_nodes)


def launch_shape(n: int, te: int = None) -> LaunchShape:
    """The launch for n x n matrices: the entries a thread (``te``: 2, 4, 8 or 10;
    given, it is kept) and the warps and tiles that cover the ``n^2`` entries
    with the fewest issue slots, counting padded entries and forming the
    monomials once a tile. Pure."""
    entries = n * n
    best = None
    for t in (te,) if te else (10, 8, 4, 2):
        if t not in MAX_WARPS:
            raise ValueError(f"te must be 2, 4, 8 or 10; got {t}")
        tiles = -(-entries // (MAX_WARPS[t] * t))
        warps = -(-entries // (tiles * t))
        cost = tiles * (warps * t + _FORMING) * _PACE[t]
        if best is None or cost < best[0]:
            best = (cost, LaunchShape(t, warps, tiles))
    return best[1]


class Expansion:
    """An expansion as :func:`contract_monomials` reads it: the
    ``polynomial`` (an ``ArrayPolynomial``, for its labels and the plain
    version's monomials), ``planes`` (2 n^2, M), ``start`` (2 n^2, 1) or None,
    and ``n``. The kernel's operands are made on the planes' device at the
    first launch and kept.

    The kernel forms the monomials in one of two ways, each the plain
    version's products in its order. Table mode: every node of the product
    table (``ArrayPolynomial``'s: each label's prefixes) as parent times
    variable, degree by degree; ``nodes`` holds each node's (slot, parent
    slot or -1, variable, 0), sorted by degree, with label k's node in slot k
    and the other prefixes after the labels. Fold mode (where a lane tile's
    nodes do not fit shared memory): each label's variables multiplied left to
    right, ``variables[offsets[k]:offsets[k + 1]]``."""

    def __init__(self, polynomial, planes, start, n: int):
        labels = [tuple(label) for label in polynomial.monomial_labels]
        if planes.ndim != 2 or planes.shape != (2 * n * n, len(labels)):
            raise ValueError(f"planes must be (2 n^2, M) = {(2 * n * n, len(labels))}; got "
                             f"{tuple(planes.shape)}")
        if start is not None and start.shape != (2 * n * n, 1):
            raise ValueError(f"start must be (2 n^2, 1); got {tuple(start.shape)}")
        if any(len(label) == 0 for label in labels):
            raise ValueError("every monomial label needs at least one variable")
        self.polynomial, self.planes, self.start, self.n = polynomial, planes, start, n
        self.n_vars = 1 + max(max(label) for label in labels)
        self.offsets = np.cumsum([0] + [len(label) for label in labels]).astype(np.int32)
        self.variables = np.array([v for label in labels for v in label], dtype=np.int32)
        self.nodes, self.levels = _node_table(labels)
        self._operands = {}

    def operands(self, shape: LaunchShape):
        """The kernel's operands at ``shape`` on the planes' device: ``nodes``,
        ``levels``, ``offsets``, ``variables`` (int32), the coefficients packed
        as (tiles, M, entries a tile, 2) float32 with zeros past n^2, and the
        constant term as (2 n^2,) float32 (or None)."""
        if shape not in self._operands:
            device = self.planes.device
            tables = [torch.as_tensor(x, device=device)
                      for x in (self.nodes, self.levels, self.offsets, self.variables)]
            self._operands[shape] = (*tables, pack_planes(self.planes.float(), self.n, shape),
                                     None if self.start is None
                                     else self.start.float().reshape(-1).contiguous())
        return self._operands[shape]


def _node_table(labels):
    """(nodes, levels) of table mode for ``labels`` (a node per distinct
    prefix; with repeated labels the table is empty and the kernel folds)."""
    if len(set(labels)) != len(labels):
        return np.zeros((0, 4), dtype=np.int32), np.zeros(1, dtype=np.int32)
    slot = {label: k for k, label in enumerate(labels)}
    prefixes = sorted({label[:d] for label in labels for d in range(1, len(label) + 1)},
                      key=lambda ms: (len(ms), ms))
    for prefix in prefixes:
        slot.setdefault(prefix, len(slot))
    nodes = np.array([(slot[x], slot[x[:-1]] if len(x) > 1 else -1, x[-1], 0) for x in prefixes],
                     dtype=np.int32)
    degrees = np.array([len(x) for x in prefixes])
    levels = np.searchsorted(degrees, np.arange(1, degrees.max() + 2)).astype(np.int32)
    return nodes, levels


def pack_planes(planes, n: int, shape: LaunchShape):
    """``planes`` (2 n^2, M) as the kernel reads them: (tiles, M, entries a
    tile, 2), entry ``tile * entries_per_tile + j`` and plane ``p`` of term k at
    ``[tile, k, j, p]``, zero past n^2."""
    entries, terms = n * n, planes.shape[1]
    per_tile = shape.entries_per_tile
    out = planes.new_zeros((terms, shape.tiles * per_tile, 2))
    out[:, :entries] = planes.reshape(2, entries, terms).permute(2, 1, 0)
    return out.reshape(terms, shape.tiles, per_tile, 2).transpose(0, 1).contiguous()


def _check(coeffs, expansion: Expansion):
    if coeffs.ndim != 2:
        raise ValueError(f"coeffs must be (n_vars, L); got {tuple(coeffs.shape)}")
    if expansion.n_vars > coeffs.shape[0]:
        raise ValueError(f"the expansion's labels name variable {expansion.n_vars - 1}; coeffs "
                         f"has {coeffs.shape[0]}")
    if coeffs.device != expansion.planes.device or coeffs.dtype != expansion.planes.dtype:
        raise TypeError("coeffs and the expansion's planes must share one device and one dtype; "
                        f"got {coeffs.device}, {coeffs.dtype} and {expansion.planes.device}, "
                        f"{expansion.planes.dtype}")


def contract_monomials(coeffs, expansion: Expansion, interleaved: bool = False):
    """The expansion at every lane of ``coeffs`` (n_vars, L) real: complex
    (n, n, L) if ``interleaved``, else real (2, n, n, L) planes.
    Differentiable in ``coeffs``."""
    _check(coeffs, expansion)
    if coeffs.is_cuda and coeffs.dtype == torch.float32:
        return _Contract.apply(coeffs, expansion, bool(interleaved))
    return contract_monomials_plain(coeffs, expansion, interleaved)


def contract_monomials_plain(coeffs, expansion: Expansion, interleaved: bool = False):
    """Plain version of :func:`contract_monomials`: the monomial table by
    ``compute_monomials``, one real product (``addmm`` with the constant
    term), differentiable."""
    n, L = expansion.n, coeffs.shape[1]
    monomials = expansion.polynomial.compute_monomials(coeffs)  # (M, L)
    if expansion.start is None:
        lanes = expansion.planes @ monomials
    else:
        lanes = torch.addmm(expansion.start, expansion.planes, monomials)
    del monomials
    lanes = lanes.reshape(2, n, n, L)
    return torch.complex(lanes[0], lanes[1]) if interleaved else lanes


_LIB = Library("monomial_contract", {"monomial_contract_launch": "p8 q i10 s"})


def plan(expansion: Expansion, shape: LaunchShape, n_vars: int, fold: bool = False):
    """``(n_nodes, chunk)``: the nodes the kernel keeps in shared memory (all
    of the expansion's, table mode, or 0, fold mode) and the most terms a
    chunk of coefficients, the first of table mode at 64 and 32 terms, then
    fold mode at 64 and 32, that fits a block's shared memory. Pure."""
    n_nodes = 0 if fold else len(expansion.nodes)
    for nodes in ((n_nodes, 0) if n_nodes else (0,)):
        for chunk in CHUNKS:
            if shape.smem_bytes(nodes, n_vars, chunk) <= MAX_SHARED_BYTES:
                return nodes, chunk
    raise ValueError(f"the monomial_contract kernel does not fit n = {expansion.n}")


def _launch_kernel(coeffs, expansion: Expansion, interleaved: bool, te: int = None,
                   fold: bool = False):
    """The kernel's launch; ``te`` and ``fold`` force an instantiation and
    fold mode (tests and timing scripts)."""
    n, (n_vars, L) = expansion.n, coeffs.shape
    shape = launch_shape(n, te)
    nodes, levels, offsets, variables, packed, start = expansion.operands(shape)
    n_nodes, chunk = plan(expansion, shape, n_vars, fold)
    coeffs = coeffs.contiguous()
    if interleaved:
        out = torch.empty((n, n, L), dtype=torch.complex64, device=coeffs.device)
    else:
        out = torch.empty((2, n, n, L), dtype=torch.float32, device=coeffs.device)
    if L:
        _LIB.monomial_contract_launch(coeffs, nodes, levels, offsets, variables, packed, start,
                                      out, L, packed.shape[1], n * n, n_vars, n_nodes,
                                      len(levels) - 1, chunk, shape.te, shape.warps, shape.tiles,
                                      int(interleaved))
    return out


class _Contract(torch.autograd.Function):
    """Kernel forward; backward the VJP of the plain version, recomputed from
    the saved coefficient table."""

    @staticmethod
    def forward(ctx, coeffs, expansion, interleaved):
        ctx.expansion, ctx.interleaved = expansion, interleaved
        ctx.save_for_backward(coeffs)
        return _launch_kernel(coeffs.detach(), expansion, interleaved)

    @staticmethod
    def backward(ctx, grad):
        (coeffs,) = ctx.saved_tensors
        with torch.enable_grad():
            c = coeffs.detach().requires_grad_(True)
            out = contract_monomials_plain(c, ctx.expansion, ctx.interleaved)
        (grad_coeffs,) = torch.autograd.grad(out, c, grad)
        return grad_coeffs, None, None
