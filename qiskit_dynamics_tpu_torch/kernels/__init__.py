"""Loader for the hand-written CUDA kernels under ``csrc/`` (see ``_build``)."""
