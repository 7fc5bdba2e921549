"""Helpers for merging expansion order/label specifications.

Counterpart of ``qiskit_dynamics_tpu/perturbation/perturbation_utils.py``
(pure Python, the port's own copy).
"""
from __future__ import annotations

from itertools import product
from typing import List, Optional

from ..exceptions import DynamicsError
from .multiset_utils import Multiset, clean_multisets, to_multiset

__all__ = ["merge_multiset_expansion_order_labels", "merge_list_expansion_order_labels"]


def _ordered_partitions(n: int, length: int) -> List[List[int]]:
    """Ordered integer partitions of ``n`` of a given length (zeros allowed)."""
    if length == 1:
        return [[n]]
    return [[k] + rest for k in range(n + 1) for rest in _ordered_partitions(n - k, length - 1)]


def merge_multiset_expansion_order_labels(
    perturbation_labels: List[Multiset],
    expansion_order: Optional[int] = None,
    expansion_labels: Optional[List] = None,
) -> List[Multiset]:
    """All multisets of size ``expansion_order`` over the elements appearing in
    ``perturbation_labels``, merged with any explicit ``expansion_labels``."""
    if expansion_order is None and expansion_labels is None:
        raise DynamicsError(
            "At least one of expansion_order or expansion_labels must be specified."
        )

    if expansion_labels is not None:
        expansion_labels = clean_multisets(expansion_labels)
    if expansion_order is None:
        return expansion_labels

    unique_elements = sorted({e for label in perturbation_labels for e in to_multiset(label)})
    counts = _ordered_partitions(expansion_order, len(unique_elements))
    generated = [
        to_multiset({elem: c for elem, c in zip(unique_elements, count) if c > 0})
        for count in counts
    ]
    if expansion_labels is not None:
        generated = generated + expansion_labels
    return clean_multisets(generated)


def merge_list_expansion_order_labels(
    perturbation_num: int,
    expansion_order: Optional[int] = None,
    expansion_labels: Optional[List[List[int]]] = None,
) -> List[List[int]]:
    """All ordered index lists of length ``expansion_order`` over
    ``range(perturbation_num)``, merged with explicit ``expansion_labels``."""
    if expansion_order is None and expansion_labels is None:
        raise DynamicsError(
            "At least one of expansion_order or expansion_labels must be specified."
        )
    if expansion_order is None:
        return [list(label) for label in expansion_labels]

    output = list(map(list, product(range(perturbation_num), repeat=expansion_order)))
    if expansion_labels is not None:
        for label in expansion_labels:
            label = list(label)
            if label not in output:
                output.append(label)
        output.sort(key=str)
        output.sort(key=len)
    return output
