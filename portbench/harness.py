"""One run of one cell: set-up, the measured window, the comparison, the
result line.

1. Build the cell's configuration and the program from it (the port's
   ``Solver`` by :mod:`portbench.program`, or the traffic's ``"program"``
   from ``portbench/programs/``), draw the amplitude sets from ``--seed`` on
   the device, and warm up with the cell's own calls: all of it is
   ``setup_s``.
2. The window: one caller issues the cell's call back to back (a closed
   loop, as a calibration or control loop that waits for each scan) and
   starts calls until ``--seconds`` have passed. Each call is timed on the
   host clock from its start to ``torch.cuda.synchronize()`` after it. After
   each call the benchmark keeps a few of its rows, drawn from the seed, and
   the worst deviation of all its members from the norm (the trace for a
   density matrix).
3. With ``--trace 1`` the calls run under ``torch.profiler`` instead, at most
   the traffic's ``trace_calls`` of them, and the per-layer metrics are read.
4. ``memory_peak_bytes`` is read, the program's state freed, and a sample of
   the kept rows, drawn from the seed, is compared with the float64
   reference (:mod:`portbench.reference`).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

from . import model as model_mod
from . import reference, spec
from . import trace as trace_mod
from .traffic import MAX_CALLS, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "qiskit_dynamics_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``qiskit_dynamics_tpu_torch`` is the port, not it)."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def program_module(traffic: dict):
    """The module whose ``Program`` makes the cell's call: the traffic's
    ``"program"``, ``portbench/programs/<name>.py``, or without one
    :mod:`portbench.program`."""
    name = traffic.get("program")
    if name is None:
        return importlib.import_module(f"{__package__}.program")
    return importlib.import_module(f"{__package__}.programs.{spec.check_name(name)}")


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, cell, model, setup_s, window_start, calls, spans, trace, shape=None):
        self.cell, self.model = cell, model
        self._shape = shape  # the program module's sweep_shape(model, traffic), if any
        self.traffic = cell.traffic
        self.members = int(cell.traffic["members"])
        self.setup_s = setup_s
        self.window_start = window_start
        self.calls = calls  # [(start, end)] host clock, seconds
        self.spans = spans  # {span name: [host seconds]}
        self.trace = trace  # trace.summarize() of a traced run, else None

    @property
    def entry(self) -> str:
        return self.traffic["entry"]

    def sweep_shape(self) -> dict:
        """The sizes a work count reads (see ``portbench/counts``)."""
        if self._shape is not None:
            return self._shape(self.model, self.traffic)
        opts = self.traffic.get("options", {})
        dim = self.model.dim
        rwa = self.model.rwa_cutoff_ghz is not None
        return dict(
            n=dim * dim if self.model.vectorized else dim,
            # the RWA splits each drive into the parts of its real and
            # imaginary envelope, two operators
            k=len(self.model.drives) * (2 if rwa else 1),
            order=int(opts.get("expm_order", 8)),
            magnus_order=int(opts.get("magnus_order", 2)),
            steps=reference.fixed_steps(self.model.t_final, float(opts["max_dt"])),
            members=self.members,
            hermitian=not self.model.vectorized,
        )


def deviation(torch, y, density: bool):
    """The worst |norm - 1| (|trace - 1| of a density matrix) over the call's
    members; NaN if any is not finite."""
    if density:
        total = torch.diagonal(y, dim1=-2, dim2=-1).sum(-1)
    else:
        total = (y.abs() ** 2).sum(-1)
    return (total - 1).abs().amax()


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()[:1]
    return line[0] if out.returncode == 0 and line else None


def readings(model, tr: dict, amps, got, g_got, devs, device) -> dict:
    """The numbers compared: ``state_err``, the largest |entry| of the rows
    ``got`` less the float64 reference's at the members ``amps``;
    ``grad_err`` (value-and-gradient cells), the largest gap of the
    gradients ``g_got`` over the largest reference gradient; ``norm_err``,
    the largest of the per-call deviations ``devs`` from the norm."""
    import torch

    ref = tr["reference"]
    problem = reference.Problem(model, device)
    steps = reference.fixed_steps(model.t_final, float(ref["max_dt"]))
    solve = lambda a: reference.solve(  # noqa: E731
        problem, a, 0.0, model.t_final, steps, int(ref["magnus_order"]), reference.Arith("float64"))
    got = got.to(torch.complex128)
    out = {}
    if tr["entry"] == "value_and_grad":
        a = amps.detach().clone().requires_grad_(True)
        want = solve(a)
        # each member's share of the mean over the call's members
        loss = (want[:, tr["loss_index"]].abs() ** 2).sum() / tr["members"]
        (g_ref,) = torch.autograd.grad(loss, a)
        out["state_err"] = float((got - want.detach()).abs().max())
        out["grad_err"] = float((g_got.double() - g_ref).abs().max() / g_ref.abs().max())
    else:
        with torch.no_grad():
            out["state_err"] = float((got - solve(amps)).abs().max())
    out["norm_err"] = float(devs.double().max())
    return out


def compare(cell, model, traffic, kept, device):
    """The numbers compared with their limits, ``{name: (value, limit)}``,
    over a sample of the kept rows drawn from the seed, and the count of
    calls whose members left the norm by more than its limit."""
    import torch

    tr = cell.traffic
    limits = tr["limits"]
    devs = torch.stack([d for _, _, d in kept]).double().cpu()
    failed = int(((devs > limits["norm_err"]) | torch.isnan(devs)).sum())
    call_idx, slot_idx = traffic.sample(len(kept), int(tr["probes"]))
    rows = traffic.rows[call_idx, slot_idx]
    pool = traffic.sets.shape[0]
    amps = traffic.sets[torch.as_tensor(call_idx, device=rows.device) % pool, rows]
    got = torch.stack([kept[c][0][s] for c, s in zip(call_idx, slot_idx)])
    g_got = None
    if tr["entry"] == "value_and_grad":
        g_got = torch.stack([kept[c][1][s] for c, s in zip(call_idx, slot_idx)])
    values = readings(model, tr, amps, got, g_got, devs, device)
    return {name: (v, float(limits[name])) for name, v in values.items()}, failed


def execute(cell, seed: int, seconds: float, traced: bool, device, t0: float, wrap=None):
    """Run the cell; returns the result object (without its last line's
    printing). ``wrap`` replaces the program's call (the tests plant faults
    with it)."""
    import torch

    program_mod = program_module(cell.traffic)  # imports the port
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tr = cell.traffic
    marks = [("start", t0), ("imports", time.perf_counter())]
    if cuda:
        torch.cuda.init()
        marks.append(("cuda", time.perf_counter()))
    model = model_mod.build(cell.config)
    spans = trace_mod.Spans()
    program = program_mod.Program(model, tr, device, span=spans)
    call = wrap(program.call) if wrap else program.call
    traffic = Traffic(tr, seed, device)
    density = model.vectorized
    marks.append(("solver", time.perf_counter()))

    def keep(i, y, g):
        rows = traffic.rows[i]
        return (y[rows], None if g is None else g.detach()[rows], deviation(torch, y, density))

    for i in range(int(tr["warmup_calls"])):
        y, g = call(traffic.amplitudes(i))
        sync()
        keep(i, y, g)
    sync()
    spans.seconds.clear()
    marks.append(("warm-up", time.perf_counter()))
    # what set-up allocated (the imports above all) stays alive for the whole
    # run: move it out of the collector's reach, so that a full collection in
    # the window traverses the calls' objects and not the imports' (without
    # it, 75-160 ms pauses in most 10 s windows on the card's host)
    gc.collect()
    gc.freeze()

    prof = None
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        spans.traced = True
        program.sync_spans = cuda
    max_calls = min(MAX_CALLS, int(tr["trace_calls"])) if traced else MAX_CALLS

    kept, calls = [], []
    window_start = time.perf_counter()
    marks.append(("profiler" if traced else "window", window_start))
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                in zip(marks, marks[1:])), file=sys.stderr, flush=True)
    while len(calls) < max_calls and (not calls or time.perf_counter() - window_start < seconds):
        i = len(calls)
        amps = traffic.amplitudes(i)
        with spans("call"):
            start = time.perf_counter()
            y, g = call(amps)
            sync()
            end = time.perf_counter()
        calls.append((start, end))
        kept.append(keep(i, y, g))
    sync()
    del y, g
    ms = sorted((e - s) * 1e3 for s, e in calls)
    print(f"window: {len(calls)} calls, first {[round((e - s) * 1e3, 3) for s, e in calls[:3]]} "
          f"ms, median {ms[len(ms) // 2]:.3f} ms, longest {ms[-1]:.3f} ms", file=sys.stderr,
          flush=True)

    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            summary = trace_mod.summarize(path)
        finally:
            os.unlink(path)
        del prof
    memory = torch.cuda.max_memory_allocated() if cuda else 0

    run = Run(cell, model, window_start - t0, window_start, calls, dict(spans.seconds), summary,
              shape=getattr(program_mod, "sweep_shape", None))
    metrics = {}
    for metric in (cell.per_layer if traced else cell.end_to_end):
        value = metric.reader().read(run)
        if value is not None:
            metrics[metric.name] = {"value": float(value), "unit": metric.unit}

    del program, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = compare(cell, model, traffic, kept, device)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    dev = dict(platform="gpu" if cuda else device.type,
               kind=torch.cuda.get_device_name(device) if cuda else device.type,
               count=cell.chips, memory_peak_bytes=int(memory))
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        if cuda:
            dev["power_limit"] = _power_limit()
    result = dict(correct=bool(correct), attempted=len(calls), failed=failed, metrics=metrics,
                  device=dev)
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
