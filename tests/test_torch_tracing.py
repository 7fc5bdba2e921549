"""The port's spans and counters (``qiskit_dynamics_tpu_torch.utils.metrics``)
on the sweep path, and the benchmark's readers of them.

CPU tests: the span tree of one ``Solver.solve_sweep`` call on the adaptive
twin, on kernel B2's plain version and on the polynomial engine; nothing
recorded and no profiler range entered while the switch is off; each span in
a ``torch.profiler`` Chrome trace at its converted start; the twin's step
counters against its step record and step budget; the polynomial
expansion's cache counters; the readers ``glue_host_ms.fwd``,
``accepted_step_share`` and ``adaptive_roofline_pct`` on tiny CPU runs of
the benchmark's cells.

Card tests (marked ``cuda``; skipped without a card): kernel B1's device
counters against its per-tile ``steps_out`` and its step record, the same
outputs with the counters on and off, and the same device operations in a
traced call. This file imports nothing of JAX; on the card run it with
``python -m pytest tests/test_torch_tracing.py --noconftest``.
"""
import collections
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch import Signal
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw
from qiskit_dynamics_tpu_torch.ops import polynomial_sweep as psw
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import sweep_arguments
from qiskit_dynamics_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "portbench" / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench import harness  # noqa: E402
from tiny import run_tiny, tiny_cell  # noqa: E402

AMPS = np.array([0.3, 0.55, 0.8, 1.0])
T_SWEEP = 4.0
# per engine: solve_sweep's keywords and the spans one call records
ENGINES = {
    "adaptive": (dict(method="fused_dopri5", atol=1e-4, rtol=1e-4, h0=0.1, tile_b=4),
                 {"sweep.tables", "sweep.lanes", "sweep.prepare", "sweep.engine",
                  "sweep.collect"}),
    "pallas": (dict(method="fused_magnus2", max_dt=0.5),
               {"sweep.tables", "sweep.lanes", "sweep.prepare", "sweep.engine",
                "sweep.collect"}),
    "poly": (dict(method="fused_magnus2", max_dt=0.5, sweep_engine="poly"),
             {"sweep.tables", "sweep.lanes", "sweep.prepare", "sweep.engine",
              "sweep.collect"}),
}


@pytest.fixture(scope="module")
def cr():
    """The dim-2 transmon pair (n = 4, two RWA operators) on the CPU."""
    solver, w1 = cr_solver(dim=2, device="cpu")
    return solver, (lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1)])


@pytest.fixture
def clean():
    """Metrics off and nothing recorded, before and after the test."""
    metrics.disable_metrics(clear=True)
    yield
    metrics.disable_metrics(clear=True)


def _solve(cr, engine, amps=AMPS, device="cpu"):
    solver, fn = cr
    y0 = np.eye(4, dtype=complex)[0]
    return solver.solve_sweep(fn, torch.as_tensor(amps, device=device),
                              t_span=(0.0, T_SWEEP), y0=y0, **ENGINES[engine][0])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_span_tree_of_one_call(cr, clean, engine):
    metrics.enable_metrics()
    _solve(cr, engine)
    records = metrics.span_records()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["sweep.call"]
    root = roots[0]
    assert root.attrs == dict(method=ENGINES[engine][0]["method"], engine=engine,
                              members=len(AMPS))
    assert {r.call for r in records} == {root.id}
    children = [r for r in records if r is not root]
    assert {r.name for r in children} == ENGINES[engine][1]
    assert all(r.parent == root.id for r in children)
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in children)
    if engine == "adaptive":
        (launch,) = [r for r in children if r.name == "sweep.engine"]
        assert launch.attrs == dict(tile_b=4, lanes=4)
    totals = metrics.span_totals()
    assert set(totals) == ENGINES[engine][1] | {"sweep.call"}
    assert all(t["self_seconds"] >= 0 and t["seconds"] >= t["self_seconds"]
               for t in totals.values())
    covered = sum(r.end_ns - r.start_ns for r in children)
    call = totals["sweep.call"]
    assert call["count"] == 1
    assert call["self_seconds"] == pytest.approx(
        1e-9 * (root.end_ns - root.start_ns - covered), abs=1e-9)


def test_two_calls_and_the_backward_have_their_own_call_ids(cr, clean):
    metrics.enable_metrics()
    _solve(cr, "pallas")
    amps = torch.tensor(AMPS, requires_grad=True)
    solver, fn = cr
    y = solver.solve_sweep(fn, amps, t_span=(0.0, T_SWEEP), y0=np.eye(4, dtype=complex)[0],
                           method="fused_magnus2", max_dt=0.5)
    torch.mean(y[:, 1].abs() ** 2).backward()
    records = metrics.span_records()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["sweep.call", "sweep.call", "sweep.backward"]
    assert len({r.id for r in roots}) == 3
    for root in roots:
        assert root.call == root.id
    assert len({r.call for r in records}) == 3


def test_off_records_nothing_and_enters_no_range(cr, clean, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with metrics off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not metrics.recording()
    assert metrics.span("sweep.call", method="x") is metrics.span("sweep.engine")
    for engine in sorted(ENGINES):
        _solve(cr, engine)
    assert metrics.span_records() == [] and metrics.span_totals() == {}
    assert not [name for name in metrics.counters() if not name.startswith("kernel.")]


def test_spans_land_in_the_profiler_trace_at_their_converted_start(cr, clean, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert metrics.recording()
        for engine in ("adaptive", "pallas"):
            _solve(cr, engine)
    assert not metrics.recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation":
            events.setdefault(ev["name"], []).append(float(ev["ts"]) + base_us)
    records = metrics.span_records()
    assert [r.name for r in records if r.parent is None] == ["sweep.call"] * 2
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(metrics.trace_time_us(r.start_ns))
    for name, starts in by_name.items():
        got = sorted(events.get(name, []))
        assert len(got) == len(starts), name
        for want, ts in zip(sorted(starts), got):
            assert abs(ts - want) <= 1000.0, (name, ts - want)


@pytest.mark.cuda
def test_spans_land_in_a_cuda_trace_at_their_converted_start(clean, tmp_path, cuda):
    """The same on the card, the profiler tracing the device too: the spans'
    device-side annotations are ``gpu_user_annotation`` events, apart from
    the device's operations (kernels, copies, fills)."""
    solver, w1 = cr_solver(dim=2, device=cuda)
    on_card = (solver, lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1)])
    for engine in ("adaptive", "pallas"):  # builds the kernels
        _solve(on_card, engine, device=cuda)
    torch.cuda.synchronize()
    metrics.reset_spans()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for engine in ("adaptive", "pallas"):
            _solve(on_card, engine, device=cuda)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events, cats = {}, set()
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("sweep."):
            cats.add(ev.get("cat"))
            if ev.get("cat") == "user_annotation":
                events.setdefault(ev["name"], []).append(float(ev["ts"]) + base_us)
    assert "gpu_user_annotation" in cats
    assert not cats & {"kernel", "gpu_memcpy", "gpu_memset"}
    records = metrics.span_records()
    assert [r.name for r in records if r.parent is None] == ["sweep.call"] * 2
    for name in {r.name for r in records}:
        starts = sorted(metrics.trace_time_us(r.start_ns) for r in records if r.name == name)
        got = sorted(events.get(name, []))
        assert len(got) == len(starts), name
        for want, ts in zip(starts, got):
            assert abs(ts - want) <= 1000.0, (name, ts - want)


def _twin_inputs(cr, max_steps=4096, h0=2.0):
    solver, fn = cr
    args, kwargs, _ = sweep_arguments(
        solver.model, fn, torch.as_tensor([0.4, 0.9, 1.5, 2.0]), (0.0, T_SWEEP),
        np.eye(4, dtype=complex)[0], atol=1e-6, rtol=1e-6, max_steps=max_steps, h0=h0,
        tile_b=4, rwa_signal_map=solver._rwa_signal_map, envelope_resolution=None,
        bucket_lanes=True, t_eval=None,
    )
    return asw.prepare_inputs(*args, **kwargs)


def test_twin_counts_its_attempted_and_accepted_steps(cr, clean):
    """One tile started at too large a step: the first steps are rejected.
    The accepted count is the step record's nonzero entries; the attempted
    count is the step budget the tile needs, no more and no less."""
    metrics.enable_metrics()
    final, _, rec = asw.sweep_dopri5_lockstep_plain(_twin_inputs(cr), record_steps=True)
    counts = metrics.counters()
    attempted, accepted = counts["b1.steps_attempted"], counts["b1.steps_accepted"]
    assert accepted == int((rec > 0).sum()) and attempted > accepted > 0
    assert bool(torch.isfinite(final).all())
    metrics.disable_metrics()
    enough, _, _ = asw.sweep_dopri5_lockstep_plain(_twin_inputs(cr, max_steps=attempted))
    short, _, _ = asw.sweep_dopri5_lockstep_plain(_twin_inputs(cr, max_steps=attempted - 1))
    assert torch.equal(enough, final)
    assert bool(torch.isnan(short).all())


def test_expansion_cache_hits_and_misses(clean):
    gen = np.random.default_rng(1505)
    n, k = 3, 2
    static = -1j * np.diag(gen.uniform(size=n))
    ops = -1j * gen.normal(size=(k, n, n))
    coef = torch.as_tensor(gen.uniform(size=(2, 2, k, 2)))
    y0 = torch.zeros((n, 2), dtype=torch.complex128)
    y0[0] = 1.0
    metrics.enable_metrics()
    first = psw.sweep_expm_magnus_poly(static, ops, None, coef, y0, dt=0.1)
    assert metrics.counters() == {"poly.expansion_misses": 1}
    second = psw.sweep_expm_magnus_poly(static, ops, None, coef, y0, dt=0.1)
    assert metrics.counters() == {"poly.expansion_misses": 1, "poly.expansion_hits": 1}
    assert torch.equal(first, second)


def test_solve_span_keeps_its_records(clean):
    with metrics.solve_span("solve_ode[RK4]", method="RK4"):
        pass
    assert metrics.solve_metrics() == [] and metrics.span_records() == []
    metrics.enable_metrics()
    with metrics.solve_span("solve_ode[RK4]", method="RK4"):
        pass
    (record,) = metrics.solve_metrics()
    assert record.method == "RK4" and record.wall_time_s >= 0
    (span,) = metrics.span_records()
    assert span.name == "solve_ode[RK4]" and span.parent is None


# --- the benchmark's readers ------------------------------------------------
@pytest.mark.parametrize("cell", ["cr_amp_sweep", "cr_fixed_sweep", "cr_pair_open_sweep"])
def test_readers_on_a_tiny_traced_run(clean, cell):
    result = run_tiny(tiny_cell(cell), traced=True)
    assert result["correct"]
    got = result["metrics"]
    assert 0 < got["glue_host_ms.fwd"]["value"] < 1e4
    totals = metrics.span_totals()
    calls = totals["sweep.call"]["count"]
    assert calls == result["attempted"]
    glue_s = totals["sweep.call"]["seconds"] - totals["sweep.engine"]["seconds"]
    assert got["glue_host_ms.fwd"]["value"] == pytest.approx(1e3 * glue_s / calls, rel=1e-9)
    if cell == "cr_amp_sweep":
        counts = metrics.counters()
        share = 100.0 * counts["b1.steps_accepted"] / counts["b1.steps_attempted"]
        assert got["accepted_step_share"]["value"] == pytest.approx(share)
        assert 0 < share <= 100
    else:
        assert "accepted_step_share" not in got
    # a CPU run has no device busy time: no roofline share
    assert "adaptive_roofline_pct" not in got


def test_untraced_run_reads_no_spans(clean):
    result = run_tiny(tiny_cell("cr_amp_sweep"))
    assert metrics.span_records() == [] and "glue_host_ms.fwd" not in result["metrics"]


def _reader(name):
    cell = tiny_cell("cr_amp_sweep")
    (metric,) = [m for m in cell.per_layer if m.name == name]
    return metric.reader()


class _Run:
    """The parts of ``harness.Run`` the readers read."""

    def __init__(self, model, trace, window_start=0.0):
        self.model, self.trace, self.window_start = model, trace, window_start
        self.entry = "forward"


def test_adaptive_roofline_reader_arithmetic(clean):
    from portbench import model as model_mod
    from portbench.counts import adaptive_dopri5, roofline

    model = model_mod.build(tiny_cell("cr_amp_sweep").config)
    metrics.enable_metrics()
    for _ in range(2):
        with metrics.span("sweep.call"), metrics.span("sweep.engine", tile_b=512, lanes=10240):
            metrics.count("b1.steps_accepted", 20 * 130)
            metrics.count("b1.steps_attempted", 20 * 140)
    run = _Run(model, dict(call_busy_s=2 * 4.4e-3, calls=2))
    flops = adaptive_dopri5.flops(16, 2, 512, [20 * 130])
    least_s, _ = roofline.bound(flops, adaptive_dopri5.nbytes(16, 2, 10240))
    got = _reader("adaptive_roofline_pct").read(run)
    assert got == pytest.approx(100 * least_s / 4.4e-3)
    assert 5 < got < 20  # B1's bound ~0.5 ms of a ~4.4 ms call
    assert _reader("accepted_step_share").read(run) == pytest.approx(100 * 130 / 140)
    idle_card = _Run(model, dict(call_busy_s=0.0, calls=2))
    assert _reader("adaptive_roofline_pct").read(idle_card) is None


@pytest.mark.parametrize("name", ["glue_host_ms.fwd", "accepted_step_share",
                                  "adaptive_roofline_pct"])
def test_readers_report_nothing_for_a_program_without_spans(clean, monkeypatch, name):
    """A program older than the spans and counters has neither API: the
    readers return None and do not raise."""
    from portbench import model as model_mod

    metrics.enable_metrics()
    with metrics.span("sweep.call"), metrics.span("sweep.engine", tile_b=4, lanes=4):
        metrics.count("b1.steps_accepted", 3)
        metrics.count("b1.steps_attempted", 4)
    for attr in ("span_records", "counters"):
        monkeypatch.delattr(metrics, attr)
    run = _Run(model_mod.build(tiny_cell("cr_amp_sweep").config), dict(call_busy_s=1.0, calls=1))
    assert _reader(name).read(run) is None


def test_harness_runs_the_new_readers_by_name():
    names = {m.name for m in harness.spec.load_cell("cr_amp_sweep").per_layer}
    assert {"glue_host_ms.fwd", "accepted_step_share", "adaptive_roofline_pct"} <= names
    for cell in ("cr_fixed_sweep", "cr_pair_open_sweep"):
        names = {m.name for m in harness.spec.load_cell(cell).per_layer}
        assert "glue_host_ms.fwd" in names and "accepted_step_share" not in names


# --- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel B1 has no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(cuda, members=2048, tile_b=512):
    gen = np.random.default_rng(15)
    solver, w1 = cr_solver(dim=4, device=cuda)
    fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]  # noqa: E731
    amps = torch.as_tensor(gen.uniform(0.25, 1.0, members), device=cuda)
    args, kwargs, _ = sweep_arguments(
        solver.model, fn, amps, (0.0, 100.0), np.eye(16, dtype=complex)[0], atol=1e-6,
        rtol=1e-6, max_steps=4096, h0=0.1, tile_b=tile_b,
        rwa_signal_map=solver._rwa_signal_map, envelope_resolution=None, bucket_lanes=True,
        t_eval=None,
    )
    return asw.prepare_inputs(*args, **kwargs)


@pytest.mark.cuda
def test_b1_device_counters_match_its_step_records(cuda, clean):
    inputs = _cuda_inputs(cuda)
    tiles = inputs.batch // inputs.tile_b
    off, _, rec_off = asw._launch_kernel(inputs, True)
    assert asw.metrics.device_counters(asw.STEP_COUNTERS, cuda) is None
    metrics.enable_metrics()
    steps = torch.zeros(tiles, dtype=torch.int32, device=cuda)
    on, _, rec = asw._launch_kernel(inputs, True, steps_out=steps)
    counts = metrics.counters()
    assert counts["b1.steps_attempted"] == int(steps.sum())
    assert counts["b1.steps_accepted"] == int((rec > 0).sum())
    assert int(steps.sum()) >= counts["b1.steps_accepted"] > 0
    assert torch.equal(on, off) and torch.equal(rec, rec_off)
    twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(inputs, record_steps=True)
    assert torch.equal(twin_rec, rec)
    twin_counts = metrics.counters()
    # the twin adds the same numbers on the host
    assert twin_counts["b1.steps_attempted"] == 2 * counts["b1.steps_attempted"]
    assert twin_counts["b1.steps_accepted"] == 2 * counts["b1.steps_accepted"]


def _device_ops(prof_path, window="test.window"):
    """The device operations (kernels, copies, fills) that start inside the
    range ``window`` of a Chrome trace, by name."""
    events = json.loads(Path(prof_path).read_text())["traceEvents"]
    (start, end), = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
                     if ev.get("cat") == "user_annotation" and ev.get("name") == window]
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    return sorted(ev["name"] for ev in events
                  if ev.get("ph") == "X" and ev.get("cat") in cats and start <= ev["ts"] <= end)


@pytest.mark.cuda
def test_b1_counters_launch_nothing_in_a_traced_call(cuda, clean, tmp_path, monkeypatch):
    solver, w1 = cr_solver(dim=4, device=cuda)
    fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]  # noqa: E731
    amps = torch.linspace(0.25, 1.0, 1024, device=cuda)

    def call():
        with torch.no_grad():
            return solver.solve_sweep(fn, amps, t_span=(0.0, 100.0),
                                      y0=np.eye(16, dtype=complex)[0], method="fused_dopri5",
                                      atol=1e-6, rtol=1e-6, h0=0.1)

    call()  # warm-up: builds the kernel and makes the counters
    torch.cuda.synchronize()
    ops, outs = [], []
    for on in (True, False):
        if not on:
            monkeypatch.setattr(asw.metrics, "device_counters", lambda *args: None)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            # the first events of a session may come before the device
            # tracing is up: count those of a range that starts later
            torch.cuda.synchronize()
            time.sleep(0.1)
            with torch.profiler.record_function("test.window"):
                outs.append(call())
                torch.cuda.synchronize()
        path = tmp_path / f"trace_{on}.json"
        prof.export_chrome_trace(str(path))
        ops.append(_device_ops(path))
    on, off = collections.Counter(ops[0]), collections.Counter(ops[1])
    assert on == off and on, (on - off, off - on)
    assert torch.equal(outs[0], outs[1])
    assert metrics.counters()["b1.steps_attempted"] > 0
