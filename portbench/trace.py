"""Spans of the benchmark and the reading of a ``torch.profiler`` trace.

The benchmark marks its own calls into the program with spans
(``portbench.<name>``): on the host clock always, and as profiler ranges in
a traced run. The profiler's Chrome trace gives the device's operations
(kernels, copies, fills) on the host's time line; :func:`summarize` reduces
it, over the traced calls, to what the per-layer readers and the result's
``device`` and ``breakdown`` need.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import time
from typing import Dict, List

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120


class Spans:
    """Host-clock durations of the benchmark's spans, by name; in a traced
    run each span is also a profiler range."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        ctx = torch.profiler.record_function(PREFIX + name) if self.traced else (
            contextlib.nullcontext())
        with ctx:
            start = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - start)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(merged, s, e):
    """The parts of sorted disjoint ``merged`` intervals inside [s, e]."""
    starts = [m[0] for m in merged]
    i = max(0, bisect.bisect_right(starts, s) - 1)
    out = []
    while i < len(merged) and merged[i][0] < e:
        a, b = max(merged[i][0], s), min(merged[i][1], e)
        if b > a:
            out.append((a, b))
        i += 1
    return out


def _host_activity(events, queries):
    """For each time in ``queries`` (sorted), the innermost host operation
    running then, over all threads: the one that started last."""
    by_tid = collections.defaultdict(list)
    for ev in events:
        by_tid[ev[3]].append(ev)
    answers = [(float("-inf"), "") for _ in queries]
    for evs in by_tid.values():
        evs.sort(key=lambda ev: (ev[0], -ev[1]))
        stack, j = [], 0
        for qi, t in enumerate(queries):
            while j < len(evs) and evs[j][0] <= t:
                while stack and stack[-1][1] <= evs[j][0]:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            if stack and stack[-1][0] > answers[qi][0]:
                answers[qi] = (stack[-1][0], stack[-1][2])
    return [name for _, name in answers]


def summarize(trace_path) -> dict:
    """Reduce a Chrome trace to the traced calls' device time.

    Returns a dict of: ``calls`` (the number of ``portbench.call`` ranges),
    ``call_s`` (their summed wall time), ``window_s`` (first call's start to
    last call's end), ``busy_s`` (the union of device operations in the
    window), ``call_busy_s`` (that union inside the calls), ``launches``
    (device operations that start inside the calls), ``device_ops`` and
    ``idle_gaps`` (the ten largest, as [name, seconds]).
    """
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    calls, spans, device, host = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and name.startswith(PREFIX):
            (calls if name == PREFIX + "call" else spans).append((s, e, name[len(PREFIX):],
                                                                 ev.get("tid")))
        elif cat in DEVICE_CATS:
            device.append((s, e, name))
        elif cat in HOST_CATS:
            host.append((s, e, name, ev.get("tid")))
    calls.sort()
    out = dict(calls=len(calls), call_s=0.0, window_s=0.0, busy_s=0.0, call_busy_s=0.0,
               launches=0, device_ops=[], idle_gaps=[])
    if not calls:
        return out
    w0, w1 = calls[0][0], calls[-1][1]
    merged = _merge([(s, e) for s, e, _ in device])
    out["window_s"] = w1 - w0
    out["busy_s"] = sum(b - a for a, b in _clip(merged, w0, w1))
    by_name = collections.Counter()
    for s, e, name in device:
        if e > w0 and s < w1:
            by_name[name[:NAME_CHARS]] += min(e, w1) - max(s, w0)
    out["device_ops"] = [[n, v] for n, v in by_name.most_common(TOP)]

    call_starts = [c[0] for c in calls]
    gaps = []
    for cs, ce, _, _ in calls:
        out["call_s"] += ce - cs
        busy = _clip(merged, cs, ce)
        out["call_busy_s"] += sum(b - a for a, b in busy)
        edges = [cs] + [x for ab in busy for x in ab] + [ce]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    for s, _, _ in device:
        i = bisect.bisect_right(call_starts, s) - 1
        if i >= 0 and s < calls[i][1]:
            out["launches"] += 1

    # each gap goes to what the host was doing at its middle: the innermost
    # benchmark span and the innermost host operation
    gaps.sort(key=lambda g: g[0] + g[1])
    mids = [0.5 * (a + b) for a, b in gaps]
    span_names = _host_activity([(s, e, n, 0) for s, e, n, _ in spans], mids)
    op_names = _host_activity(host, mids)
    idle = collections.Counter()
    for (a, b), span, op in zip(gaps, span_names, op_names):
        idle[f"{span or 'call'} > {op or 'python'}"[:NAME_CHARS]] += b - a
    out["idle_gaps"] = [[n, v] for n, v in idle.most_common(TOP)]
    return out
