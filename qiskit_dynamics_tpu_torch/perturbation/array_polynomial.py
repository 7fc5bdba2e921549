r"""Multivariable array-valued polynomials.

Counterpart of ``qiskit_dynamics_tpu/perturbation/array_polynomial.py``.
Represents :math:`f(c) = A_\emptyset + \sum_{I \in S} c_I A_I` with multiset
monomial labels.

Coefficients given as numpy arrays stay on the host; evaluated at a tensor
``c`` they are uploaded to the device of ``c`` once (a cache keyed by device
and dtype), not per call. Coefficients given as tensors stay tensors.

Monomials are not evaluated by one padded gather (which materializes an
``(M, degree, ...)`` temporary, 10 GB for the order-6 Dyson sweep): the
labels are compiled on the host into a table in which every monomial is a
lower one times one variable, and evaluation walks that table one degree at
a time, so the largest temporary is the ``(M, ...)`` result itself.
Polynomial evaluation is then one ``tensordot`` onto the stacked
coefficients.

Algebraic operations (add / mul / matmul, with optional monomial filtering for
degree truncation) compile sparse product rules on the host and execute through
:mod:`.custom_dot`.
"""
from __future__ import annotations

import warnings
from itertools import product as _iter_product
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..exceptions import DynamicsError
from ..unified import is_tensor
from .custom_dot import CustomMatmul, CustomMul
from .multiset_utils import (
    Multiset,
    sorted_multisets,
    submultisets_and_complements,
    to_multiset,
)

__all__ = ["ArrayPolynomial"]


def _is_arraylike(x) -> bool:
    return isinstance(
        x, (int, float, complex, list, tuple, np.ndarray, torch.Tensor)
    ) and not isinstance(x, ArrayPolynomial)


def _compile_monomial_table(labels: List[Multiset]):
    """The product table of ``labels``: one list entry per degree ``d``,
    ``(parent, var)`` index arrays such that the degree-``d`` nodes are
    ``nodes_{d-1}[parent] * c[var]`` (``parent`` is None at degree 1). Nodes
    are all prefixes of the labels, sorted canonically; ``positions`` gives
    each label's row among the concatenated nodes, or None when the nodes
    are exactly the labels in order (the case of a complete expansion)."""
    nodes = sorted({label[:d] for label in labels for d in range(1, len(label) + 1)},
                   key=lambda ms: (len(ms), ms))
    by_degree: dict = {}
    for node in nodes:
        by_degree.setdefault(len(node), []).append(node)
    levels = []
    for degree in sorted(by_degree):
        level = by_degree[degree]
        var = np.array([node[-1] for node in level], dtype=np.int64)
        if degree == 1:
            parent = None
        else:
            below = {node: i for i, node in enumerate(by_degree[degree - 1])}
            parent = np.array([below[node[:-1]] for node in level], dtype=np.int64)
        levels.append((parent, var))
    where = {node: i for i, node in enumerate(nodes)}
    positions = np.array([where[label] for label in labels], dtype=np.int64)
    if len(positions) == len(nodes) and np.array_equal(positions, np.arange(len(nodes))):
        positions = None
    return levels, positions


class ArrayPolynomial:
    r"""A polynomial with array-valued coefficients.

    :math:`f(c) = A_\emptyset + \sum_I c_I A_I` where for a multiset
    :math:`I = (i_1, ..., i_k)`, :math:`c_I = c_{i_1} \cdots c_{i_k}`.

    Instantiated with ``constant_term`` (:math:`A_\emptyset`),
    ``array_coefficients`` (stacked :math:`A_I`), and ``monomial_labels``
    (multisets in any coercible form). Supports evaluation ``ap(c)``,
    array-like methods (``conj``, ``transpose``, ``trace``, ``sum``, ``real``,
    indexing), and algebra (``+``, ``*``, ``@``; ``add``/``mul``/``matmul``
    with a ``monomial_filter`` for degree truncation).
    """

    __array_priority__ = 20

    def __init__(
        self,
        constant_term=None,
        array_coefficients=None,
        monomial_labels: Optional[List] = None,
        array_library: Optional[str] = None,
    ):
        if array_coefficients is None and constant_term is None:
            raise DynamicsError(
                "At least one of array_coefficients and constant_term must be specified."
            )

        if array_library is not None:
            if array_library not in ("numpy", "scipy_sparse"):
                raise DynamicsError(f"Unsupported array_library {array_library!r}.")
            if array_library == "scipy_sparse":
                warnings.warn(
                    "ArrayPolynomial stores coefficients dense in this build; "
                    "array_library='scipy_sparse' inputs are densified "
                    "(O(n^2) per term).",
                    stacklevel=2,
                )
                if array_coefficients is not None:
                    array_coefficients = _densify(array_coefficients)
                if constant_term is not None:
                    constant_term = _densify(constant_term)

        if monomial_labels is not None:
            self._monomial_labels = [to_multiset(m) for m in monomial_labels]
        else:
            self._monomial_labels = []

        if array_coefficients is not None and len(self._monomial_labels) != len(
            array_coefficients
        ):
            raise DynamicsError(
                "array_coefficients and monomial_labels must have matching lengths."
            )

        self._array_coefficients = None
        if array_coefficients is not None:
            self._array_coefficients = _as_array(array_coefficients)
        self._constant_term = None
        if constant_term is not None:
            self._constant_term = _as_array(constant_term)

        self._levels, self._positions = None, None
        if self._monomial_labels:
            self._levels, self._positions = _compile_monomial_table(self._monomial_labels)
        # device copies of host coefficients and of the index tables
        self._tensor_cache: dict = {}
        self._index_cache: dict = {}

    @property
    def monomial_labels(self) -> List[Multiset]:
        """Multiset labels of the non-constant terms (canonical sorted tuples)."""
        return self._monomial_labels

    @property
    def array_coefficients(self):
        """Stacked coefficient arrays for non-constant terms."""
        return self._array_coefficients

    @property
    def constant_term(self):
        """The constant term."""
        return self._constant_term

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._constant_term is not None:
            return tuple(self._constant_term.shape)
        return tuple(self._array_coefficients.shape[1:])

    @property
    def ndim(self) -> int:
        if self._constant_term is not None:
            return self._constant_term.ndim
        return self._array_coefficients.ndim - 1

    def tensors(self, device, dtype: torch.dtype):
        """``(array_coefficients, constant_term)`` as tensors on ``device`` in
        the complex ``dtype`` (None where the polynomial has none). Host
        coefficients are uploaded on the first call and kept."""
        key = (torch.device(device), dtype)
        if key not in self._tensor_cache:
            self._tensor_cache[key] = tuple(
                None if x is None else torch.as_tensor(x, device=key[0]).to(dtype)
                for x in (self._array_coefficients, self._constant_term)
            )
        return self._tensor_cache[key]

    def _index_tables(self, device):
        """The monomial product table as index tensors on ``device``."""
        device = torch.device(device)
        if device not in self._index_cache:
            def put(x):
                return None if x is None else torch.as_tensor(x, device=device)

            self._index_cache[device] = (
                [(put(parent), put(var)) for parent, var in self._levels],
                put(self._positions),
            )
        return self._index_cache[device]

    def compute_monomials(self, c):
        """All monomial values :math:`c_I`, ordered as ``monomial_labels``.

        ``c`` may have trailing batch dimensions: shape ``(r, ...)`` produces
        monomials of shape ``(M, ...)``. Walks the product table one degree
        at a time, writing each degree's values into its rows of the result;
        differentiable in a tensor ``c``.
        """
        if not self._monomial_labels:
            return None
        if is_tensor(c):
            levels, positions = self._index_tables(c.device)
            count = sum(len(var) for _, var in levels)
            out = c.new_empty((count,) + tuple(c.shape[1:]))
        else:
            c = np.asarray(c)
            levels, positions = self._levels, self._positions
            count = sum(len(var) for _, var in levels)
            out = np.empty((count,) + c.shape[1:], dtype=c.dtype)
        start, values = 0, None
        for parent, var in levels:
            values = c[var] if parent is None else values[parent] * c[var]
            out[start:start + len(var)] = values
            start += len(var)
        return out if positions is None else out[positions]

    def __call__(self, c=None):
        """Evaluate the polynomial at variable values ``c``."""
        if self._array_coefficients is None:
            return self._constant_term
        monomials = self.compute_monomials(c)
        if is_tensor(monomials) or is_tensor(self._array_coefficients):
            if is_tensor(self._array_coefficients):
                coeffs, const = self._array_coefficients, self._constant_term
                if not is_tensor(monomials):
                    monomials = torch.as_tensor(monomials, device=coeffs.device)
                if const is not None:
                    const = torch.as_tensor(const, device=coeffs.device)
            else:
                cdtype = torch.promote_types(monomials.dtype, torch.complex64)
                coeffs, const = self.tensors(monomials.device, cdtype)
            dtype = torch.promote_types(coeffs.dtype, monomials.dtype)
            val = torch.tensordot(coeffs.to(dtype), monomials.to(dtype), dims=([0], [0]))
            if const is not None:
                batch = (1,) * (val.ndim - const.ndim)
                val = const.reshape(tuple(const.shape) + batch) + val
            return val
        val = np.tensordot(self._array_coefficients, monomials, axes=(0, 0))
        if self._constant_term is not None:
            batch = (1,) * (val.ndim - self._constant_term.ndim)
            val = self._constant_term.reshape(self._constant_term.shape + batch) + val
        return val

    # ------------------------------------------------------------------ #
    # array-like methods
    # ------------------------------------------------------------------ #

    def _map_terms(self, const_fn: Callable, coeff_fn: Callable) -> "ArrayPolynomial":
        const = const_fn(self._constant_term) if self._constant_term is not None else None
        coeffs = coeff_fn(self._array_coefficients) if self._array_coefficients is not None else None
        return ArrayPolynomial(
            constant_term=const,
            array_coefficients=coeffs,
            monomial_labels=list(self._monomial_labels),
        )

    def conj(self) -> "ArrayPolynomial":
        """Entrywise conjugate."""
        return self._map_terms(lambda a: a.conj(), lambda a: a.conj())

    def transpose(self, axes: Optional[Tuple[int, ...]] = None) -> "ArrayPolynomial":
        """Transpose all terms."""
        if axes is None:
            axes = tuple(range(self.ndim))[::-1]
        shifted = (0,) + tuple(ax + 1 for ax in axes)

        def permute(a, ax):
            return a.permute(ax) if is_tensor(a) else np.transpose(a, ax)

        return self._map_terms(lambda a: permute(a, axes), lambda a: permute(a, shifted))

    def trace(self, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None) -> "ArrayPolynomial":
        """Trace of all terms."""
        if self.ndim < 2:
            raise DynamicsError("ArrayPolynomial.trace() requires ndim at least 2.")

        def tr(a, a1, a2):
            if is_tensor(a):
                out = torch.diagonal(a, offset=offset, dim1=a1, dim2=a2).sum(-1)
                return out if dtype is None else out.to(dtype)
            return np.trace(a, offset=offset, axis1=a1, axis2=a2, dtype=dtype)

        return self._map_terms(
            lambda a: tr(a, axis1, axis2), lambda a: tr(a, axis1 + 1, axis2 + 1)
        )

    def sum(self, axis=None, dtype=None) -> "ArrayPolynomial":
        """Sum each term over ``axis``."""
        if axis is None:
            coeff_axis: Union[None, int, Tuple[int, ...]] = tuple(range(1, self.ndim + 1))
            if self.ndim == 0:
                coeff_axis = ()
        elif isinstance(axis, int):
            coeff_axis = axis + 1
        else:
            coeff_axis = tuple(a + 1 for a in axis)

        def total(a, ax):
            if is_tensor(a):
                if ax == ():
                    return a if dtype is None else a.to(dtype)
                return a.sum(dtype=dtype) if ax is None else a.sum(dim=ax, dtype=dtype)
            return a.sum(axis=ax, dtype=dtype)

        return self._map_terms(lambda a: total(a, axis), lambda a: total(a, coeff_axis))

    @property
    def real(self) -> "ArrayPolynomial":
        """Real part of all terms."""
        return self._map_terms(lambda a: a.real, lambda a: a.real)

    def __getitem__(self, idx) -> "ArrayPolynomial":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self._map_terms(lambda a: a[idx], lambda a: a[(slice(None),) + idx])

    def __len__(self) -> int:
        n = 0
        if self._array_coefficients is not None:
            n += len(self._array_coefficients)
        if self._constant_term is not None:
            n += 1
        return n

    # ------------------------------------------------------------------ #
    # algebra
    # ------------------------------------------------------------------ #

    def add(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Add, optionally keeping only terms whose label passes ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(
                "Only types castable as an ArrayPolynomial can be added to an ArrayPolynomial."
            )
        return _poly_add(self, other, monomial_filter)

    def matmul(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Matmul, optionally truncating via ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.matmul.")
        return _poly_distributive_op(self, other, CustomMatmul, monomial_filter)

    def mul(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Entrywise multiply, optionally truncating via ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.mul.")
        return _poly_distributive_op(self, other, CustomMul, monomial_filter)

    def __add__(self, other):
        return self.add(other)

    def __radd__(self, other):
        return self.add(other)

    def __neg__(self):
        return self._map_terms(lambda a: -a, lambda a: -a)

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self).add(other)

    def __mul__(self, other):
        return self.mul(other)

    def __rmul__(self, other):
        return self.mul(other)

    def __matmul__(self, other):
        return self.matmul(other)

    def __rmatmul__(self, other):
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if isinstance(other, ArrayPolynomial):
            return other.matmul(self)
        raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.__rmatmul__.")


def _densify(x):
    if hasattr(x, "toarray"):
        return x.toarray()
    if isinstance(x, (list, tuple)):
        return [e.toarray() if hasattr(e, "toarray") else e for e in x]
    return x


def _as_array(x):
    """A tensor stays a tensor (a list holding tensors is stacked); anything
    else becomes numpy."""
    if is_tensor(x):
        return x
    if isinstance(x, (list, tuple)) and any(is_tensor(e) for e in x):
        return torch.stack([torch.as_tensor(e) for e in x])
    return np.asarray(x)


class _Lib:
    """The few array functions the algebra needs, in numpy or in torch on the
    device of the tensor operands."""

    def __init__(self, *arrays):
        tensors = [a for a in arrays if is_tensor(a)]
        self.torch = bool(tensors)
        self.device = tensors[0].device if tensors else None

    def asarray(self, x):
        if self.torch:
            return torch.as_tensor(x, device=self.device)
        return np.asarray(x)

    def zeros(self, shape):
        if self.torch:
            return torch.zeros(shape, dtype=torch.complex128, device=self.device)
        return np.zeros(shape, dtype=complex)

    def concatenate(self, parts):
        if self.torch:
            dtype = parts[0].dtype
            for p in parts[1:]:
                dtype = torch.promote_types(dtype, p.dtype)
            return torch.cat([p.to(dtype) for p in parts], dim=0)
        return np.concatenate(parts, axis=0)


def _poly_add(
    ap1: ArrayPolynomial, ap2: ArrayPolynomial, monomial_filter: Optional[Callable]
) -> ArrayPolynomial:
    for a, b in zip(ap1.shape[::-1], ap2.shape[::-1]):
        if not (a == 1 or b == 1 or a == b):
            raise DynamicsError("ArrayPolynomial addition requires broadcastable shapes.")
    if monomial_filter is None:
        monomial_filter = lambda _: True

    xp = _Lib(ap1.array_coefficients, ap2.array_coefficients, ap1.constant_term,
              ap2.constant_term)
    const = None
    if monomial_filter(()):
        if ap1.constant_term is not None and ap2.constant_term is not None:
            const = xp.asarray(ap1.constant_term) + xp.asarray(ap2.constant_term)
        elif ap1.constant_term is not None:
            const = ap1.constant_term
        elif ap2.constant_term is not None:
            const = ap2.constant_term

    if ap1.array_coefficients is None and ap2.array_coefficients is None:
        return ArrayPolynomial(constant_term=const)

    labels = sorted_multisets(
        {m for m in ap1.monomial_labels + ap2.monomial_labels if monomial_filter(m)}
    )
    idx1 = np.array([ap1.monomial_labels.index(m) if m in ap1.monomial_labels else -1 for m in labels] or [-1])
    idx2 = np.array([ap2.monomial_labels.index(m) if m in ap2.monomial_labels else -1 for m in labels] or [-1])

    # each polynomial pads with its OWN shape; the final add broadcasts
    zero1 = xp.zeros((1,) + ap1.shape)
    zero2 = xp.zeros((1,) + ap2.shape)
    coeffs1 = (
        xp.concatenate([xp.asarray(ap1.array_coefficients), zero1])
        if ap1.array_coefficients is not None
        else zero1
    )
    coeffs2 = (
        xp.concatenate([xp.asarray(ap2.array_coefficients), zero2])
        if ap2.array_coefficients is not None
        else zero2
    )
    new_coeffs = coeffs1[xp.asarray(idx1)] + coeffs2[xp.asarray(idx2)]
    return ArrayPolynomial(
        constant_term=const, array_coefficients=new_coeffs, monomial_labels=labels
    )


def _poly_distributive_op(
    ap1: ArrayPolynomial,
    ap2: ArrayPolynomial,
    op_cls,
    monomial_filter: Optional[Callable],
) -> ArrayPolynomial:
    """Distribute a product (``op_cls``: ``CustomMatmul`` or ``CustomMul``)
    over all term pairs, with label filtering.

    Output label for a pair ``(I, J)`` is the multiset sum ``I + J``. The
    sparse rule over (constant + coefficient) stacks is compiled on the host
    and executed via :mod:`.custom_dot`."""
    if monomial_filter is None:
        monomial_filter = lambda _: True

    labels = set()
    if ap1.constant_term is not None:
        labels.update(m for m in ap2.monomial_labels if monomial_filter(m))
    if ap2.constant_term is not None:
        labels.update(m for m in ap1.monomial_labels if monomial_filter(m))
    for I, J in _iter_product(ap1.monomial_labels, ap2.monomial_labels):
        IuJ = tuple(sorted(I + J))
        if monomial_filter(IuJ):
            labels.add(IuJ)
    labels = sorted_multisets(labels)

    xp = _Lib(ap1.array_coefficients, ap2.array_coefficients, ap1.constant_term,
              ap2.constant_term)
    const = None
    if ap1.constant_term is not None and ap2.constant_term is not None and monomial_filter(()):
        c1, c2 = xp.asarray(ap1.constant_term), xp.asarray(ap2.constant_term)
        const = c1 @ c2 if op_cls is CustomMatmul else c1 * c2

    if not labels:
        return ArrayPolynomial(constant_term=const)

    # rule over stacked [constant, *coefficients]; constant encoded as -1
    rule = []
    for ms in labels:
        pairs = []
        if ms in ap1.monomial_labels:
            pairs.append([ap1.monomial_labels.index(ms), -1])
        if ms in ap2.monomial_labels:
            pairs.append([-1, ap2.monomial_labels.index(ms)])
        if len(ms) > 1:
            for I, J in zip(*submultisets_and_complements(ms)):
                if I in ap1.monomial_labels and J in ap2.monomial_labels:
                    pair = [ap1.monomial_labels.index(I), ap2.monomial_labels.index(J)]
                    if pair not in pairs:
                        pairs.append(pair)
        if pairs:
            rule.append((np.ones(len(pairs)), np.array(pairs, dtype=int)))

    def stacked(ap):
        if ap.constant_term is not None:
            head = xp.asarray(ap.constant_term)[None]
        else:
            head = xp.zeros((1,) + ap.shape)
        if ap.array_coefficients is not None:
            return xp.concatenate([head, xp.asarray(ap.array_coefficients)])
        return head

    new_coeffs = op_cls(rule, index_offset=1)(stacked(ap1), stacked(ap2))
    return ArrayPolynomial(
        constant_term=const, array_coefficients=new_coeffs, monomial_labels=labels
    )
