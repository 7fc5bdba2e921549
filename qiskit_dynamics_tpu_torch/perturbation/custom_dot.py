"""Compiled sparse linear-combination binary ops (compiled on the host).

Counterpart of ``qiskit_dynamics_tpu/perturbation/custom_dot.py``. Implements
the ``(A x B)_i = sum_jk a_ijk f(A_j, B_k)`` primitive underlying the
Dyson/Magnus term recursions.

The sparse rule, a list of ``(coeffs, index_pairs)`` per output entry, is
compiled **on the host** into dense padded tables:

- ``pairs``: (E, 2) int array of unique ``(j, k)`` evaluation pairs
  (padded with ``(-1, -1)``);
- ``coeffs``/``idx``: (I, L) linear-combination tables (padded with 0 / -1).

Execution is then branch-free: one gather, one batched binary op over the
unique pairs, and one linear combination. numpy arrays in, numpy out (the
host precompute, complex128); tensors in, tensors out on their device.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..unified import is_tensor

__all__ = ["CompiledRule", "compile_rule", "CustomMatmul", "CustomMul"]


class CompiledRule:
    """Container for a compiled rule: ``(pairs, (coeffs, idx))``."""

    __slots__ = ("pairs", "coeffs", "idx")

    def __init__(self, pairs: np.ndarray, coeffs: np.ndarray, idx: np.ndarray):
        self.pairs = pairs
        self.coeffs = coeffs
        self.idx = idx

    def astuple(self):
        return self.pairs, (self.coeffs, self.idx)


def compile_rule(
    operation_rule: List[Tuple[np.ndarray, np.ndarray]],
    index_offset: int = 0,
    unique_evaluation_len: Optional[int] = None,
    linear_combo_len: Optional[int] = None,
) -> CompiledRule:
    """Compile a sparse rule into padded unique-pair + linear-combo tables.

    Args:
        operation_rule: list over output entries; each entry is
            ``(coeffs, index_pairs)`` with ``index_pairs`` of shape (m, 2).
        index_offset: shift added to all indices (used to encode "generator at
            -1" conventions).
        unique_evaluation_len: minimum row count for the pair table (padded
            with ``(-1, -1)``), used to stack rules of different sizes.
        linear_combo_len: minimum column count for the combo tables.
    """
    unique_pairs: List[Tuple[int, int]] = []
    pair_index: dict = {}
    combo_rows: List[Tuple[np.ndarray, List[int]]] = []
    for coeffs, index_pairs in operation_rule:
        coeffs = np.asarray(coeffs)
        index_pairs = np.asarray(index_pairs, dtype=int) + index_offset
        row_idx: List[int] = []
        for pair in index_pairs:
            key = (int(pair[0]), int(pair[1]))
            if key not in pair_index:
                pair_index[key] = len(unique_pairs)
                unique_pairs.append(key)
            row_idx.append(pair_index[key])
        combo_rows.append((coeffs, row_idx))

    pairs = np.asarray(unique_pairs, dtype=int).reshape(-1, 2)
    if unique_evaluation_len is not None and unique_evaluation_len > len(pairs):
        pad = -np.ones((unique_evaluation_len - len(pairs), 2), dtype=int)
        pairs = np.concatenate([pairs, pad], axis=0)

    max_len = max([linear_combo_len or 0] + [len(c) for c, _ in combo_rows])
    coeff_table = np.zeros((len(combo_rows), max_len), dtype=complex)
    idx_table = -np.ones((len(combo_rows), max_len), dtype=int)
    for i, (coeffs, row_idx) in enumerate(combo_rows):
        coeff_table[i, : len(coeffs)] = coeffs
        idx_table[i, : len(row_idx)] = row_idx

    return CompiledRule(pairs, coeff_table, idx_table)


def _apply_torch(A, B, rule: CompiledRule, binary_op: Callable):
    """One gather, one batched product, one linear combination, on the
    device of ``A``. A zero row is appended so padded ``(-1, -1)`` pairs and
    padded ``-1`` combination slots gather zeros."""
    device = A.device
    dtype = torch.promote_types(A.dtype, B.dtype)
    A, B = A.to(dtype), B.to(dtype)
    A = torch.cat([A, A.new_zeros((1,) + A.shape[1:])], dim=0)
    B = torch.cat([B, B.new_zeros((1,) + B.shape[1:])], dim=0)
    pairs = torch.as_tensor(np.asarray(rule.pairs), device=device)
    uniq = binary_op(A[pairs[:, 0]], B[pairs[:, 1]])
    uniq = torch.cat([uniq, uniq.new_zeros((1,) + uniq.shape[1:])], dim=0)
    gathered = uniq[torch.as_tensor(np.asarray(rule.idx), device=device)]  # (I, L, ...)
    # real operands keep a real result: the rule's coefficients are real then
    coeffs = np.asarray(rule.coeffs)
    coeffs = torch.as_tensor(coeffs if dtype.is_complex else coeffs.real, device=device).to(dtype)
    return torch.einsum("il,il...->i...", coeffs, gathered)


def _apply_numpy(A, B, rule: CompiledRule, binary_op: Callable):
    """The same three steps in complex128 numpy (the host precompute: this is
    the right-hand side of the joint Dyson ODE, called once per stage)."""
    A = np.asarray(A, dtype=complex)
    B = np.asarray(B, dtype=complex)
    A = np.concatenate([A, np.zeros((1,) + A.shape[1:], dtype=complex)], axis=0)
    B = np.concatenate([B, np.zeros((1,) + B.shape[1:], dtype=complex)], axis=0)
    pairs = np.asarray(rule.pairs)
    uniq = binary_op(A[pairs[:, 0]], B[pairs[:, 1]])
    uniq = np.concatenate([uniq, np.zeros((1,) + uniq.shape[1:], dtype=complex)], axis=0)
    gathered = uniq[np.asarray(rule.idx)]
    return np.einsum("il,il...->i...", np.asarray(rule.coeffs), gathered)


def _align(a, b):
    """Stacks ``(E, ...)`` whose elements differ in rank: singleton axes go in
    after the stack axis of the lower one, so the elements broadcast as they
    would one by one."""
    while a.ndim < b.ndim:
        a = a[:, None]
    while b.ndim < a.ndim:
        b = b[:, None]
    return a, b


def _stacked_mul(a, b):
    a, b = _align(a, b)
    return a * b


def _stacked_matmul(a, b):
    """``a[e] @ b[e]`` for every ``e``; 1-d elements are vectors."""
    if a.ndim == 2 and b.ndim == 2:
        return (a * b).sum(-1)
    if a.ndim == 2:
        return (a[:, None, :] @ b)[..., 0, :]
    if b.ndim == 2:
        return (a @ b[:, :, None])[..., 0]
    a, b = _align(a, b)
    return a @ b


class _CustomBinaryOp:
    """Custom binary op from a (possibly pre-compiled) sparse rule.
    ``binary_op`` acts on whole stacks: ``binary_op(a, b)[e]`` is the product
    of ``a[e]`` and ``b[e]``."""

    def __init__(self, operation_rule, binary_op: Callable, index_offset: int = 0):
        self._binary_op = binary_op
        if isinstance(operation_rule, CompiledRule):
            self._rule = operation_rule
        elif (
            isinstance(operation_rule, tuple)
            and len(operation_rule) == 2
            and isinstance(operation_rule[1], tuple)
        ):
            pairs, (coeffs, idx) = operation_rule
            self._rule = CompiledRule(pairs, coeffs, idx)
        else:
            self._rule = compile_rule(operation_rule, index_offset)

    @property
    def compiled_rule(self) -> CompiledRule:
        return self._rule

    def __call__(self, A, B):
        if is_tensor(A) or is_tensor(B):
            device = A.device if is_tensor(A) else B.device
            A = torch.as_tensor(A, device=device)
            B = torch.as_tensor(B, device=device)
            return _apply_torch(A, B, self._rule, self._binary_op)
        return _apply_numpy(A, B, self._rule, self._binary_op)


class CustomMatmul(_CustomBinaryOp):
    """Compiled linear combination of matrix products."""

    def __init__(self, operation_rule, index_offset: int = 0):
        super().__init__(operation_rule, _stacked_matmul, index_offset)


class CustomMul(_CustomBinaryOp):
    """Compiled linear combination of elementwise products."""

    def __init__(self, operation_rule, index_offset: int = 0):
        super().__init__(operation_rule, _stacked_mul, index_offset)
