"""The one boundary between the port's Python and its hand-written CUDA kernels.

A :class:`Library` holds the C signatures of one kernel library
(``csrc/<name>.cu``), one short string per entry, and gives each entry as a
Python callable. The library is built and loaded (:func:`._build.load`) at the
first use of an entry, never at import.

A signature lists the argument types in order, each a letter with an optional
count: ``p`` a pointer, ``i`` an ``int``, ``q`` a ``long long``, ``d`` a
``double``, ``f`` a ``float``; a last ``s`` is the CUDA stream, which the
caller does not pass. ``-> i``, ``-> q`` or ``-> z`` (``size_t``) marks a
query and names what it returns; every other entry returns an error code.
The callable of an entry:

- takes tensors for pointers (``None`` or an empty tensor is a null pointer;
  anything else, such as a ``ctypes`` reference, is passed as it is), and
  ints and floats;
- where the signature ends with ``s`` (a launch), runs under the device of
  its first CUDA tensor and appends that device's current stream;
- raises ``RuntimeError("<entry> failed: <the library's error string>")``
  when an error code is not 0;
- counts each launch as ``kernel.launches.<entry>``
  (:func:`~qiskit_dynamics_tpu_torch.utils.metrics.counters`), whatever the
  metrics switch says, and nothing while the stream captures a CUDA graph: a
  capture launches nothing, its replays do (their owner counts them);
- returns a query's value unchanged.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import metrics
from . import _build

__all__ = ["Library", "MAX_SHARED_BYTES", "launches"]

MAX_SHARED_BYTES = 232448  # dynamic shared memory a block may use on Hopper

_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong, "z": ctypes.c_size_t,
          "d": ctypes.c_double, "f": ctypes.c_float, "s": ctypes.c_void_p}


def _pointer(value):
    if isinstance(value, torch.Tensor):
        return value.data_ptr() if value.numel() else None
    return value


class Library:
    """The entries of ``csrc/<name>.cu`` by their ``signatures`` (entry name:
    signature); ``defines`` (preprocessor names) build another library from
    the same source, see :meth:`variant`."""

    def __init__(self, name: str, signatures: dict, defines: tuple = ()):
        self.name, self.signatures, self.defines = name, dict(signatures), tuple(defines)

    def variant(self, *defines: str) -> "Library":
        """The same entries from a build with ``defines`` (for experiments;
        the package's wrappers use none)."""
        return Library(self.name, self.signatures, defines)

    @functools.cached_property
    def cdll(self) -> ctypes.CDLL:
        return _build.load(self.name, self.defines)

    @property
    def path(self) -> str:
        """The loaded library's file (its ptxas report is ``path + ".ptxas.txt"``)."""
        return self.cdll._name

    def __getattr__(self, entry: str):
        signature = self.__dict__.get("signatures", {}).get(entry)
        if signature is None:
            raise AttributeError(f"the {self.__dict__.get('name')} library has no entry {entry!r}")
        call = self._bind(entry, signature)
        setattr(self, entry, call)
        return call

    def _bind(self, entry: str, signature: str):
        args, _, result = signature.partition("->")
        types = "".join(token[0] * int(token[1:] or 1) for token in args.split())
        fn = self.cdll[entry]
        fn.argtypes = [_TYPES[t] for t in types]
        fn.restype = _TYPES[result.strip() or "i"]
        if result:
            return lambda *values: fn(*map(_pointer, values))
        error = self.cdll[f"{self.name}_error_string"]
        error.argtypes, error.restype = [ctypes.c_int], ctypes.c_char_p
        launch, counter = types.endswith("s"), f"kernel.launches.{entry}"

        def call(*values):
            capturing = False
            if launch:
                device = next((v.device for v in values
                               if isinstance(v, torch.Tensor) and v.is_cuda), None)
                with torch.cuda.device(device):
                    code = fn(*map(_pointer, values), torch.cuda.current_stream().cuda_stream)
                    capturing = torch.cuda.is_current_stream_capturing()
            else:
                code = fn(*map(_pointer, values))
            if code != 0:
                raise RuntimeError(f"{entry} failed: {error(code).decode()}")
            if launch and not capturing:
                metrics.count(counter, always=True)

        return call


def launches(*entries: str) -> int:
    """The launches of ``entries`` counted since the last
    :func:`~qiskit_dynamics_tpu_torch.utils.metrics.reset_spans`."""
    counts = metrics.counters()
    return sum(counts.get(f"kernel.launches.{entry}", 0) for entry in entries)
