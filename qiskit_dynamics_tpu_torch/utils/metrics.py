"""The port's spans and counters, and per-solve metrics.

Counterpart of ``qiskit_dynamics_tpu/utils/metrics.py``, grown into the
port's one tracing facility:

- :func:`span` marks a stage of the program: its name, start and end on the
  host clock (``time.perf_counter_ns()``), the span it runs inside and its
  call (the outermost span around it). While a ``torch.profiler`` records,
  a span is also a ``torch.profiler.record_function`` range, so it lands in
  the profiler's Chrome trace beside the device's operations.
- :func:`count` adds to a host counter; :func:`device_counters` hands a
  kernel a persistent device tensor to add into, read only by
  :func:`counters` (one synchronize then, never inside a call).
- :func:`span_records`, :func:`span_totals`, :func:`counters` and
  :func:`reset_spans` read and clear what was recorded.
- :func:`solve_span` is the span around one ``solve_ode``/``solve_lmde``
  call; with :func:`enable_metrics` it also keeps a :class:`SolveMetrics`
  record, read by :func:`solve_metrics`.

**The switch.** Spans and counters record only while :func:`enable_metrics`
is in force or a ``torch.profiler`` is recording. Otherwise a span costs a
flag check and one call into torch's C library: it enters no range and
records nothing. A traced run of a benchmark therefore records the program's
spans with no change to the benchmark, and an untraced run pays almost
nothing. The kernels' build and load counts (``kernel.builds``,
``kernel.loads``) are kept whatever the switch says.

**Clocks.** Span times are ``time.perf_counter_ns()``, the clock a benchmark
times its calls on. :func:`trace_time_us` maps one onto the clock of the
profiler's Chrome trace through a ``(perf_counter_ns, time_ns)`` pair taken
at the first record since the last reset: an event's ``ts`` plus the trace's
``baseTimeNanoseconds`` / 1e3 is ``time.time_ns()`` / 1e3 at its start (torch
2.13 on the CPU; torch 2.11 with CUDA 12.8 on an NVIDIA H100). A span's
start is taken before its range is entered and its end after the range is
left, so a span holds its range.

Wall times are the host's: a device operation is enqueued, not finished,
when a span around it ends, unless the span also waits for it.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "SolveMetrics", "SpanRecord", "enable_metrics", "disable_metrics", "solve_metrics",
    "solve_span", "span", "annotate_call", "recording", "count", "device_counters", "counters",
    "span_records", "span_totals", "reset_spans", "trace_time_us",
]

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclass
class SolveMetrics:
    """Statistics for one solve call."""

    method: str
    wall_time_s: float


@dataclass(frozen=True)
class SpanRecord:
    """One finished span: ``parent`` is the id of the span it ran inside
    (``None`` for a call's outermost span), ``call`` the id of that
    outermost span; times are ``time.perf_counter_ns()``."""

    id: int
    name: str
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int
    attrs: dict


class _Recorder:
    """What the spans and counters recorded, and the switch."""

    MAX_RECORDS = 100_000
    MAX_SOLVES = 1000

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.local = threading.local()  # each thread's stack of open spans
        self.ids = itertools.count(1)
        self.clock = None  # (perf_counter_ns, time_ns), taken at the first record
        self.records = collections.deque(maxlen=self.MAX_RECORDS)
        self.totals: Dict[str, List[int]] = {}  # name: [count, ns, self ns]
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self.device: Dict[tuple, torch.Tensor] = {}  # (names, device): int64 tensor
        self.solves: List[SolveMetrics] = []

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def reset(self):
        with self.lock:
            self.clock = None
            self.records.clear()
            self.totals.clear()
            self.counts.clear()
        for tensor in self.device.values():
            tensor.zero_()


_REC = _Recorder()


def recording() -> bool:
    """Whether spans and counters record now: :func:`enable_metrics` is in
    force or a ``torch.profiler`` is recording."""
    return _REC.enabled or _profiler_enabled()


def enable_metrics():
    """Record spans, counters and per-solve metrics until :func:`disable_metrics`."""
    _REC.enabled = True


def disable_metrics(clear: bool = False):
    """Stop recording (a running profiler still records spans); with
    ``clear``, forget every record, total and counter."""
    _REC.enabled = False
    if clear:
        _REC.solves.clear()
        _REC.reset()


def solve_metrics() -> List[SolveMetrics]:
    """Per-solve records kept under :func:`enable_metrics`, oldest first."""
    return list(_REC.solves)


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "child_ns", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _REC.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_REC.ids)
        self.call = self.parent.call if self.parent is not None else self.id
        self.child_ns = 0
        if _REC.clock is None:
            _REC.clock = (time.perf_counter_ns(), time.time_ns())
        self.start = time.perf_counter_ns()
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _REC.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        duration = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += duration
        record = SpanRecord(self.id, self.name, None if parent is None else parent.id, self.call,
                            self.start, end, self.attrs)
        with _REC.lock:
            _REC.records.append(record)
            total = _REC.totals.setdefault(self.name, [0, 0, 0])
            total[0] += 1
            total[1] += duration
            total[2] += duration - self.child_ns
        return False


class _SolveSpan(_Span):
    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if _REC.enabled:
            wall_s = (time.perf_counter_ns() - self.start) * 1e-9
            _REC.solves.append(SolveMetrics(method=self.attrs["method"], wall_time_s=wall_s))
            del _REC.solves[:-_REC.MAX_SOLVES]
        return False


def span(name: str, **attrs):
    """A context manager that records the stage ``name`` with ``attrs``
    while :func:`recording`, and does nothing otherwise."""
    if not (_REC.enabled or _profiler_enabled()):
        return _OFF
    return _Span(name, attrs)


def solve_span(name: str, method: str = ""):
    """The span ``name`` around one solve; under :func:`enable_metrics` it
    also keeps a :class:`SolveMetrics` record of ``method`` (default
    ``name``) and the host wall time."""
    if not (_REC.enabled or _profiler_enabled()):
        return _OFF
    return _SolveSpan(name, {"method": method or name})


def annotate_call(**attrs):
    """Add ``attrs`` to the open outermost span of this thread (the call's),
    if it records."""
    if not (_REC.enabled or _profiler_enabled()):
        return
    stack = _REC.stack()
    if stack:
        stack[0].attrs.update(attrs)


def count(name: str, n: int = 1, always: bool = False):
    """Add ``n`` to the host counter ``name`` while :func:`recording`, or
    ``always``."""
    if always or _REC.enabled or _profiler_enabled():
        with _REC.lock:
            _REC.counts[name] += n


def device_counters(names: Sequence[str], device) -> Optional[torch.Tensor]:
    """The int64 tensor on ``device`` into which a kernel adds the counters
    ``names`` (one entry each) while :func:`recording`, else ``None``.

    The tensor is made, zeroed, at the first request on the device, whether
    or not anything records then, so that a traced call never pays for its
    fill."""
    key = (tuple(names), torch.device(device))
    tensor = _REC.device.get(key)
    if tensor is None:
        tensor = _REC.device[key] = torch.zeros(len(key[0]), dtype=torch.int64, device=device)
    return tensor if _REC.enabled or _profiler_enabled() else None


def counters() -> Dict[str, int]:
    """Every counter's value: the host counters plus the device counters
    (read back with one synchronize per device tensor)."""
    with _REC.lock:
        out = dict(_REC.counts)
    for (names, _), tensor in list(_REC.device.items()):
        for name, value in zip(names, tensor.tolist()):
            if value:
                out[name] = out.get(name, 0) + int(value)
    return out


def span_records() -> List[SpanRecord]:
    """The finished spans, oldest first (the last ``_Recorder.MAX_RECORDS``)."""
    with _REC.lock:
        return list(_REC.records)


def span_totals() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``seconds`` and ``self_seconds`` (the
    duration less the time its child spans cover), over every span recorded
    since the last :func:`reset_spans`."""
    with _REC.lock:
        return {name: {"count": c, "seconds": ns * 1e-9, "self_seconds": self_ns * 1e-9}
                for name, (c, ns, self_ns) in _REC.totals.items()}


def reset_spans():
    """Forget every span record, total and counter (device counters are
    zeroed)."""
    _REC.reset()


def trace_time_us(perf_ns: int) -> Optional[float]:
    """A ``time.perf_counter_ns()`` reading on the Chrome trace's clock, in
    microseconds (``ts + baseTimeNanoseconds / 1e3``); ``None`` before the
    first record."""
    if _REC.clock is None:
        return None
    p0, w0 = _REC.clock
    return (perf_ns - p0 + w0) / 1e3
