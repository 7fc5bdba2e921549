"""The hand-written CUDA kernels under ``csrc/``: their build (``_build``) and
the one boundary through which the port calls them (``boundary``)."""
from .boundary import MAX_SHARED_BYTES, Library, launches

__all__ = ["Library", "MAX_SHARED_BYTES", "launches"]
