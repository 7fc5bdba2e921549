"""Build and load the package's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` has a plain C interface. At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the root of the checkout, and loaded with
``ctypes``. A hash of the source and the flags is part of the library's file
name, so an edited source is rebuilt and a stale library is never loaded.
Only the repository's own sources are compiled; nothing is fetched.

This module imports nothing of CUDA: the build runs only when a wrapper is
about to launch a kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.metrics import count

__all__ = ["load", "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Kernels built without multiply-add contraction: each performs the same
# rounded operations as its plain version, and the chip check holds the two
# together bit for bit. chain_apply is among them because it is bound by
# bytes, so the extra instructions cost nothing, and 1,000 chained products
# feed a 1e-5 bar. The others (sweep_magnus2, member_sweep, horner_apply,
# batched_linalg, df_magnus_sweep, expm_chain) are bound by operations: they
# fuse multiply-adds and agree with their plain versions to roundoff (1e-5 on
# unit-norm inputs in float32).
NO_FMAD = frozenset({"adaptive_sweep", "chain_apply"})


def _flags(name: str, defines=()):
    return (NVCC_FLAGS + (("-fmad=false",) if name in NO_FMAD else ())
            + tuple(f"-D{d}" for d in defines))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit.")


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, and load it.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<library>.ptxas.txt``.
    ``defines`` (preprocessor names) build another library from the same
    source; the package's wrappers pass none. Every build and load adds to
    the counters ``kernel.builds`` and ``kernel.loads``
    (:func:`~qiskit_dynamics_tpu_torch.utils.metrics.counters`), whatever
    the metrics switch says: a slow set-up shows which library was built.
    """
    src = SOURCE_DIR / f"{name}.cu"
    flags = _flags(name, defines)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    tag = "".join(f"-{d}" for d in defines)
    lib_path = BUILD_DIR / f"lib{name}{tag}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        Path(str(lib_path) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
        count("kernel.builds", always=True)
    count("kernel.loads", always=True)
    return ctypes.CDLL(str(lib_path))
