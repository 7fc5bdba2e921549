"""Multiset machinery for perturbative expansions.

Counterpart of ``qiskit_dynamics_tpu/perturbation/multiset_utils.py`` (the
port's own copy: pure Python, host-side only). A multiset is a **sorted tuple
of non-negative ints**: hashable and orderable. Multiset bookkeeping happens
at set-up time; it shapes the gather and linear-combination tables that run
on the device and never appears in tensor code.

Canonical ordering: first by size, then lexicographically on the expanded
sorted-tuple form, e.g. ``(0,0,1) < (0,1,1)``.
"""
from __future__ import annotations

import itertools
from collections import Counter
from typing import Iterable, List, Optional, Sequence, Tuple, Union

from ..exceptions import DynamicsError

__all__ = [
    "Multiset",
    "to_multiset",
    "sorted_multisets",
    "clean_multisets",
    "submultiset_filter",
    "submultisets_and_complements",
    "get_all_submultisets",
    "is_submultiset",
    "multiset_complement",
]

# a multiset IS a sorted tuple of non-negative ints
Multiset = Tuple[int, ...]


def to_multiset(x: Union[Multiset, Sequence[int], dict, int]) -> Multiset:
    """Coerce ``x`` to the canonical sorted-tuple multiset form.

    Accepts sorted/unsorted int sequences, ``{element: count}`` dicts, or a
    bare int (singleton).
    """
    if isinstance(x, dict):
        elems: List[int] = []
        for k, v in x.items():
            if not isinstance(k, int) or isinstance(k, bool) or k < 0:
                raise DynamicsError(
                    "Only multisets with non-negative integer entries are accepted."
                )
            if not isinstance(v, int) or v < 0:
                raise DynamicsError("Multiset counts must be non-negative integers.")
            elems.extend([k] * v)
        return tuple(sorted(elems))
    if isinstance(x, int) and not isinstance(x, bool):
        x = [x]
    out = tuple(sorted(x))
    for e in out:
        if not isinstance(e, int) or isinstance(e, bool) or e < 0:
            raise DynamicsError("Only multisets with non-negative integer entries are accepted.")
    return out


def _sort_key(ms: Multiset) -> Tuple[int, Multiset]:
    return (len(ms), ms)


def sorted_multisets(multisets: Iterable[Multiset]) -> List[Multiset]:
    """Sort canonically: by size, then expanded-lexicographic."""
    return sorted(multisets, key=_sort_key)


def clean_multisets(multisets: Iterable) -> List[Multiset]:
    """Coerce, deduplicate, and canonically sort."""
    unique = {to_multiset(ms) for ms in multisets}
    return sorted_multisets(unique)


def is_submultiset(sub: Multiset, sup: Multiset) -> bool:
    """Whether ``sub`` is a (non-strict) submultiset of ``sup``."""
    cs, cp = Counter(sub), Counter(sup)
    return all(cp[k] >= v for k, v in cs.items())


def multiset_complement(sup: Multiset, sub: Multiset) -> Multiset:
    """The multiset difference ``sup - sub``."""
    c = Counter(sup)
    c.subtract(Counter(sub))
    out: List[int] = []
    for k, v in c.items():
        if v < 0:
            raise DynamicsError("multiset_complement requires sub <= sup.")
        out.extend([k] * v)
    return tuple(sorted(out))


def submultiset_filter(
    candidates: Sequence[Multiset], multiset_list: Sequence[Multiset]
) -> List[Multiset]:
    """Candidates that are a submultiset of some element of ``multiset_list``."""
    return [c for c in candidates if any(is_submultiset(c, ms) for ms in multiset_list)]


def submultisets_and_complements(
    multiset: Multiset, submultiset_bound: Optional[int] = None
) -> Tuple[List[Multiset], List[Multiset]]:
    """All strict submultisets of size < ``submultiset_bound``, with complements.

    Bound defaults to ``len(multiset)`` (i.e. all strict submultisets).
    Enumeration order: by size ascending, then by position-combination
    order within a size.
    """
    if submultiset_bound is None or submultiset_bound > len(multiset):
        submultiset_bound = len(multiset)

    elems = list(multiset)
    submultisets: List[Multiset] = []
    complements: List[Multiset] = []
    seen = set()
    for k in range(1, submultiset_bound):
        for locs in itertools.combinations(range(len(elems)), k):
            sub = tuple(elems[i] for i in locs)
            if sub in seen:
                continue
            seen.add(sub)
            comp = tuple(elems[i] for i in range(len(elems)) if i not in locs)
            submultisets.append(sub)
            complements.append(comp)
    return submultisets, complements


def get_all_submultisets(multisets: Iterable) -> List[Multiset]:
    """Closure of a multiset list under taking submultisets, canonically sorted.

    Built by repeatedly adding the size-(n-1) submultisets of every size-n
    member.
    """
    multisets = clean_multisets(multisets)
    if not multisets:
        return []

    by_order: dict = {}
    for ms in multisets:
        by_order.setdefault(len(ms), set()).add(ms)
    max_order = max(by_order)
    for order in range(max_order, 1, -1):
        for ms in list(by_order.get(order, ())):
            # size-(order-1) submultisets = complements of single elements
            for sub in submultisets_and_complements(ms, 2)[1]:
                by_order.setdefault(order - 1, set()).add(sub)

    full: List[Multiset] = []
    for order in sorted(by_order):
        full.extend(by_order[order])
    return sorted_multisets(full)
