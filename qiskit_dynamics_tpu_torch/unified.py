"""Host/device rule: numpy for concrete host values, torch for tensors.

The JAX package dispatches between numpy (concrete) and jax.numpy (traced).
In the port there is no trace: construction-time math on values the caller
gives as numbers, lists or numpy arrays (RWA masks, validation) stays in
numpy, and anything that is already a ``torch.Tensor`` stays a tensor, on its
device. Model state is converted to tensors once, at construction, with
:func:`to_tensor`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_device", "is_tensor", "to_numpy", "to_tensor"]


def default_device(device=None) -> torch.device:
    """The device an entry point works on: ``device`` if given, else the
    CUDA device. Without a CUDA device ``device=None`` raises: the port never
    drops to the CPU unless the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means the CUDA device, and torch finds none; pass device='cpu' "
            "to run on the host."
        )
    return torch.device("cuda")


def is_tensor(x) -> bool:
    """Whether ``x`` is a ``torch.Tensor``."""
    return isinstance(x, torch.Tensor)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device); numpy view of anything else."""
    if is_tensor(x):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def to_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor`` that keeps a tensor's device unless ``device`` is
    given, and takes host values through numpy, so Python floats and complex
    numbers become float64/complex128 (not torch's float32 default)."""
    if not is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)
