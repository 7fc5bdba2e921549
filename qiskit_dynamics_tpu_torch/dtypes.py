"""Precision configuration.

The JAX package follows ``jax_enable_x64`` globally. In the port every model
takes an explicit ``dtype`` (complex128 by default: the precision of the host
references, DOP853 at 1e-8); the sweep kernel runs its state in float32
whatever the model dtype (see ``ops/adaptive_sweep.py``). The JAX package's
"highest" matmul-precision pin is the TF32 switch set in ``__init__.py``.
"""
from __future__ import annotations

import torch


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of the same precision as ``dtype``."""
    return torch.complex64 if dtype in (torch.float32, torch.complex64) else torch.complex128
