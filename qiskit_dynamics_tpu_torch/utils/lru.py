"""Small least-recently-used caches kept in ``OrderedDict`` s, shared by the
polynomial engine's expansion caches and the adaptive sweep's CUDA graphs.

A cache holds at most :data:`ENTRIES` entries; one lock guards them all.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..unified import to_numpy

__all__ = ["ENTRIES", "LOCK", "get", "put", "operand_key"]

# entries per cache, least recently used out: at n = 1,040 a prepared
# expansion is ~200 MB
ENTRIES = 4
LOCK = threading.Lock()


def get(cache, key):
    """The entry of ``key`` (now the most recently used), or ``None``."""
    with LOCK:
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
        return hit


def put(cache, key, value):
    """Keep ``value`` under ``key``, dropping the least recently used entries
    past :data:`ENTRIES`."""
    with LOCK:
        cache[key] = value
        while len(cache) > ENTRIES:
            cache.popitem(last=False)


def operand_key(x):
    """A tensor by identity and in-place version (the entry must hold it, so
    that its id is not reused while the entry lives); anything else, or an
    inference tensor (which keeps no version), by value."""
    if isinstance(x, torch.Tensor) and not x.is_inference():
        return (id(x), x._version, tuple(x.shape), x.dtype, x.device)
    a = to_numpy(x).astype(np.complex128)
    return (a.shape, a.tobytes())
