"""The adaptive sweep's CUDA graph (``solvers/fused_sweep.py``): the folded
per-call checks, the plan's arguments, the graph's key, and on the card the
replayed graph against the eager path.

CPU tests: the host probe raises the three signal errors with their
messages; ``sweep_arguments`` returns what the glue returned before it was
split into a plan and a device chain (the earlier code is kept below as the
reference, bit for bit); each keyed input changes the key; the CPU twin
takes no graph; the benchmark's ``graph_hit_pct`` reader.

Card tests (marked ``cuda``; skipped without a card): a hit is bit-identical
to the eager path over three amplitude batches, with ``t_eval``, a 2-d
``y0``, envelope tables and without bucketing; the hit, miss and fallback
counters; a carrier or phase change is a new capture; B1's accepted steps per ``sweep.engine`` span on a hit and on the
eager path; B1's launch counter over a miss and its hits; a returned result
survives the next call. This file imports
nothing of JAX; on the card run it with ``python -m pytest
tests/test_torch_sweep_graph.py --noconftest``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch import Signal, SignalSum
from qiskit_dynamics_tpu_torch.benchmarks import cr_solver
from qiskit_dynamics_tpu_torch.exceptions import DynamicsError
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw
from qiskit_dynamics_tpu_torch.solvers import fused_sweep as fs
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import sweep_arguments
from qiskit_dynamics_tpu_torch.unified import to_numpy, to_tensor
from qiskit_dynamics_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

T_SPAN = (0.0, 2.0)
OPTIONS = dict(atol=1e-6, rtol=1e-6, max_steps=4096, h0=0.1, tile_b=4, envelope_resolution=None,
               bucket_lanes=True, t_eval=None)


@pytest.fixture
def clean():
    """Metrics off, nothing recorded and no graph kept, before and after."""
    metrics.disable_metrics(clear=True)
    fs._GRAPHS.clear()
    yield
    metrics.disable_metrics(clear=True)
    fs._GRAPHS.clear()


@pytest.fixture
def cr():
    """The dim-2 transmon pair (n = 4, two RWA operators) on the CPU."""
    solver, w1 = cr_solver(dim=2, device="cpu")
    return solver, w1


def _gaussian(a, w1):
    return [Signal(lambda t: a * 0.4 * torch.exp(-(((t - 1.0) / 0.5) ** 2)), carrier_freq=w1)]


# --- the folded checks -----------------------------------------------------
_BAD_SIGNALS = {
    "count": (lambda w1: lambda a: [Signal(lambda t: a, carrier_freq=w1)] * 2,
              "must produce 2 signals"),
    "carrier_sweep": (lambda w1: lambda a: [Signal(lambda t: a, carrier_freq=w1 * a)],
                      "does not support sweeping the carrier"),
    "envelope": (lambda w1: lambda a: _gaussian(a, w1), "requires constant-envelope signals"),
}


@pytest.mark.parametrize("case", sorted(_BAD_SIGNALS))
def test_folded_probe_raises_the_signal_errors(cr, clean, case):
    solver, w1 = cr
    make, message = _BAD_SIGNALS[case]
    with pytest.raises(DynamicsError, match=message):
        solver.solve_sweep(make(w1), torch.tensor([0.5, 0.7, 0.9]), t_span=T_SPAN,
                           y0=np.eye(4, dtype=complex)[0], method="fused_dopri5", tile_b=4)


def test_folded_probe_raises_for_a_summed_signal_of_two_carriers(cr, clean):
    solver, w1 = cr
    # no RWA map: the signal list goes to the model's two RWA operators as is
    fn = lambda a: [SignalSum(Signal(lambda t: a, carrier_freq=w1),  # noqa: E731
                              Signal(lambda t: a, carrier_freq=2.0)),
                    Signal(lambda t: a, carrier_freq=w1)]
    with pytest.raises(DynamicsError, match="single carrier frequency"):
        sweep_arguments(solver.model, fn, torch.tensor([0.5, 0.9]), T_SPAN,
                        np.eye(4, dtype=complex)[0], rwa_signal_map=None, **OPTIONS)


def test_probe_builds_each_end_once_on_the_host(cr, clean):
    """One host call of the signals each for members 0 and -1, on host
    copies; the tables' vmap is the only other call."""
    solver, w1 = cr
    seen = []

    def fn(a):
        seen.append((a.device.type, torch._C._functorch.is_batchedtensor(a)))
        return [Signal(lambda t: a * 0.4, carrier_freq=w1)]

    sweep_arguments(solver.model, fn, torch.tensor([0.5, 0.7, 0.9]), T_SPAN,
                    np.eye(4, dtype=complex)[0], rwa_signal_map=solver._rwa_signal_map, **OPTIONS)
    assert seen == [("cpu", False), ("cpu", False), ("cpu", True)]


_ENVELOPES = {
    "constant": (lambda w1: Signal(0.4, carrier_freq=w1), None),
    "constant_sum": (lambda w1: SignalSum(Signal(0.4, carrier_freq=w1),
                                          Signal(lambda t: 0.25 + 0.1j, carrier_freq=w1)), None),
    "sum_in_time": (lambda w1: SignalSum(Signal(0.3, carrier_freq=w1),
                                         Signal(lambda t: 0.2 * t, carrier_freq=w1)),
                    "constant-envelope"),
    "branching_sum": (lambda w1: SignalSum(Signal(lambda t: 0.3 if t < 1.0 else 0.5,
                                                  carrier_freq=w1)), "constant-envelope"),
}


@pytest.mark.parametrize("case", sorted(_ENVELOPES))
def test_envelope_probe_takes_only_constant_envelopes(cr, clean, case):
    """Member 0's envelopes, summed over a sum's components, one probe time
    at a time."""
    _, w1 = cr
    make, message = _ENVELOPES[case]
    if message is None:
        fs._probe_envelopes([make(w1)], *T_SPAN)
    else:
        with pytest.raises(DynamicsError, match=message):
            fs._probe_envelopes([make(w1)], *T_SPAN)


# --- the plan's arguments against the glue as it was ------------------------
def _reference_arguments(model, signals_fn, params, t_span, y0, atol, rtol, max_steps, h0, tile_b,
                         rwa_signal_map, envelope_resolution, bucket_lanes, t_eval):
    """``sweep_arguments`` as it was before the plan: probes on members 0
    and -1 of the device parameters, the tables in one vmap."""
    _, solve_dim, static_fb, ops_fb, omega, t0, tf = fs._extract_generator_data(
        model, t_span, "fused_adaptive_sweep_solve")
    device = model.device

    def flat_signals(p):
        sigs = signals_fn(p)
        return list(rwa_signal_map(sigs) if rwa_signal_map is not None else sigs)

    sigs0 = flat_signals(fs._tree_map(lambda x: x[0], params))
    freqs = np.asarray([2 * np.pi * np.atleast_1d(to_numpy(s.carrier_freq).astype(float))[0]
                        for s in sigs0])
    params = fs._tree_map(lambda x: to_tensor(x, device=device), params)
    if envelope_resolution is None:
        t_zero = torch.zeros((), dtype=torch.float64, device=device)

        def amplitudes(p):
            rows = []
            for s in flat_signals(p):
                env = to_tensor(s.envelope(t_zero)).to(torch.complex128).reshape(-1)
                ph = s.phase.to(device).reshape(-1)
                rows.append(torch.sum(env * torch.exp(1j * ph)))
            return torch.stack(rows)
        env_dt = 0.0
    else:
        n_env = int(envelope_resolution)
        env_dt = (tf - t0) / n_env
        env_times_np = t0 + (np.arange(n_env) + 0.5) * env_dt
        env_times = torch.as_tensor(env_times_np, device=device)
        carrier_phase = torch.as_tensor(np.exp(-1j * freqs[:, None] * env_times_np[None, :]),
                                        device=device)

        def amplitudes(p):
            return torch.stack([s.complex_value(env_times).to(torch.complex128) * carrier_phase[j]
                                for j, s in enumerate(flat_signals(p))])
    amps = torch.movedim(torch.func.vmap(amplitudes)(params), 0, -1).to(device)
    inv_order = None
    if bucket_lanes:
        key = torch.sum(torch.abs(amps), dim=tuple(range(amps.ndim - 1)))
        order = torch.argsort(key, stable=True)
        inv_order = torch.argsort(order)
        amps = amps[..., order]
    y0_fb = model.rotating_frame.state_into_frame_basis(y0)
    eval_ts, include_t0 = fs._eval_times(t_eval, t0, tf)
    amps, y0_cols, B, m = fs._expand_lanes(amps, y0_fb, solve_dim, tile_b)
    args = (static_fb, ops_fb, omega, freqs, amps, y0_cols)
    kwargs = dict(tf=tf, t0=t0, atol=atol, rtol=rtol, max_steps=max_steps, h0=h0,
                  tile_b=tile_b, env_dt=env_dt, eval_ts=eval_ts)

    def collect(out_kernel):
        if t_eval is not None:
            yf, traj = out_kernel if eval_ts is not None else (out_kernel, None)
            pieces = ([y0_cols.to(yf.dtype)[None]] if include_t0 else []) + (
                [traj] if traj is not None else [])
            out = fs._collect_trajectory(model, torch.cat(pieces, dim=0), B, m)
        else:
            out = fs._collect_lanes(model, out_kernel, B, m)
        return out if inv_order is None else out[inv_order]

    return args, kwargs, collect


_ARGUMENT_CASES = {
    "constant": {},
    "envelope_table": dict(envelope_resolution=16),
    "t_eval": dict(t_eval=[0.0, 0.5, 2.0]),
    "y0_2d": dict(y0=np.eye(4, dtype=complex)[:, :2]),
    "unbucketed": dict(bucket_lanes=False),
}


@pytest.mark.parametrize("case", sorted(_ARGUMENT_CASES))
def test_sweep_arguments_as_before(cr, clean, case):
    solver, w1 = cr
    options = dict(OPTIONS, y0=np.eye(4, dtype=complex)[0], rwa_signal_map=solver._rwa_signal_map)
    options.update(_ARGUMENT_CASES[case])
    fn = (lambda a: _gaussian(a, w1)) if options["envelope_resolution"] else (
        lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1, phase=0.3)])
    amps = torch.tensor([0.9, 0.3, 0.55, 1.0, 0.45, 0.7], dtype=torch.float64)
    got_args, got_kwargs, got_collect = sweep_arguments(solver.model, fn, amps, T_SPAN, **options)
    want_args, want_kwargs, want_collect = _reference_arguments(solver.model, fn, amps, T_SPAN,
                                                                **options)
    for got, want in zip(got_args, want_args):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got, want)
        else:
            assert np.array_equal(got, want)
    assert got_kwargs == want_kwargs
    out = asw.sweep_dopri5_lockstep(*want_args, **want_kwargs)
    got, want = got_collect(out), want_collect(out)
    assert torch.equal(got, want)


# --- the key --------------------------------------------------------------
def _key_inputs(cr):
    solver, w1 = cr
    fn = lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1)]  # noqa: E731
    return dict(model=solver.model, signals_fn=fn, params=torch.linspace(0.3, 1.0, 6).double(),
                t_span=T_SPAN, y0=np.eye(4, dtype=complex)[0],
                options=dict(OPTIONS, rwa_signal_map=solver._rwa_signal_map),
                baked=((2 * np.pi * w1, 2 * np.pi * w1), ((0.0,), (0.0,))), counting=False)


def _option(name, value):
    def change(inputs):
        inputs["options"] = dict(inputs["options"], **{name: value})
    return change


def _model_tensor(change):
    def apply(inputs):
        coll = inputs["model"]._operator_collection
        frame = inputs["model"].rotating_frame
        change(coll, frame)
    return apply


_KEY_CHANGES = {
    "signals_fn": lambda i: i.update(signals_fn=lambda a: i["signals_fn"](a)),
    "rwa_signal_map": _option("rwa_signal_map", lambda sigs: sigs),
    "members": lambda i: i.update(params=torch.linspace(0.3, 1.0, 7).double()),
    "params_dtype": lambda i: i.update(params=i["params"].float()),
    "params_structure": lambda i: i.update(params=(i["params"],)),
    "static_operator_version": _model_tensor(lambda c, f: c.static_operator.mul_(1.0)),
    "static_operator_identity": _model_tensor(
        lambda c, f: setattr(c, "_static_operator", c.static_operator.clone())),
    "operators_version": _model_tensor(lambda c, f: c.operators.mul_(1.0)),
    "operators_identity": _model_tensor(lambda c, f: setattr(c, "_operators", c.operators.clone())),
    "frame_version": _model_tensor(lambda c, f: f.frame_diag.mul_(1.0)),
    "frame_identity": _model_tensor(lambda c, f: setattr(f, "_frame_diag", f.frame_diag.clone())),
    "y0_value": lambda i: i.update(y0=np.eye(4, dtype=complex)[1]),
    "y0_tensor_version": lambda i: i.update(y0=torch.eye(4, dtype=torch.complex128)[0]),
    "t0": lambda i: i.update(t_span=(0.5, 2.0)),
    "tf": lambda i: i.update(t_span=(0.0, 3.0)),
    "atol": _option("atol", 1e-7),
    "rtol": _option("rtol", 1e-7),
    "max_steps": _option("max_steps", 100),
    "h0": _option("h0", 0.2),
    "tile_b": _option("tile_b", 8),
    "envelope_resolution": _option("envelope_resolution", 16),
    "bucket_lanes": _option("bucket_lanes", False),
    "t_eval": _option("t_eval", [0.5, 2.0]),
    "carriers": lambda i: i.update(baked=((1.0, 1.0), i["baked"][1])),
    "phases": lambda i: i.update(baked=(i["baked"][0], ((0.0,), (0.3,)))),
    "counting": lambda i: i.update(counting=True),
}


@pytest.mark.parametrize("case", sorted(_KEY_CHANGES))
def test_each_keyed_input_changes_the_key(cr, case):
    inputs = _key_inputs(cr)
    before = fs._graph_key(**inputs)
    refs = fs._graph_refs(inputs["model"], inputs["signals_fn"], inputs["y0"],
                          inputs["options"])  # held, as an entry holds them
    _KEY_CHANGES[case](inputs)
    if case == "y0_tensor_version":
        y0 = inputs["y0"]
        first = fs._graph_key(**inputs)
        y0.mul_(1.0)
        assert fs._graph_key(**inputs) != first
    assert fs._graph_key(**inputs) != before
    del refs


def test_the_baked_values_are_the_carriers_and_member_zero_phases(cr, clean):
    solver, w1 = cr
    fn = lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1, phase=0.3)]  # noqa: E731
    ends = fs._member_ends(torch.tensor([0.5, 0.7, 0.9]))
    probe = fs._probe_carriers(fs._flat_signals(fn, solver._rwa_signal_map), ends, 2)
    carriers, phases = fs._baked(probe)
    assert carriers == tuple(float(f) for f in probe[0]) and len(carriers) == 2
    assert phases == tuple(tuple(np.ravel(to_numpy(s.phase)).tolist()) for s in probe[1])
    assert 0.3 in phases[0] + phases[1]
    hash((carriers, phases))


def test_the_key_ignores_parameter_values(cr):
    inputs = _key_inputs(cr)
    before = fs._graph_key(**inputs)
    hash(before)
    inputs["params"] = torch.linspace(0.1, 0.2, 6).double()
    assert fs._graph_key(**inputs) == before


def test_the_cpu_twin_takes_no_graph(cr, clean):
    solver, w1 = cr
    metrics.enable_metrics()
    for _ in range(2):
        solver.solve_sweep(lambda a: [Signal(lambda t: a * 0.4, carrier_freq=w1)],
                           torch.tensor([0.5, 0.9]), t_span=T_SPAN,
                           y0=np.eye(4, dtype=complex)[0], method="fused_dopri5", tile_b=4)
    assert not [name for name in metrics.counters() if name.startswith("sweep.graph")]
    assert not fs._GRAPHS


# --- the benchmark's reader -----------------------------------------------
def test_graph_hit_pct_reader(clean, monkeypatch):
    import importlib.util

    path = ROOT / "portbench" / "metrics" / "graph_hit_pct.py"
    spec = importlib.util.spec_from_file_location("graph_hit_pct", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)

    class Run:
        trace = dict(calls=4)

    assert reader.read(Run()) is None  # nothing counted
    metrics.enable_metrics()
    metrics.count("sweep.graph_misses")
    metrics.count("sweep.graph_hits", 198)
    metrics.count("sweep.graph_fallbacks")
    assert reader.read(Run()) == pytest.approx(99.0)
    Run.trace = None
    assert reader.read(Run()) is None  # untraced
    Run.trace = dict(calls=4)
    monkeypatch.delattr(metrics, "counters")
    assert reader.read(Run()) is None  # a program without counters


# --- on the card ------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph holds kernel B1, which has no CPU mode)")
    return torch.device("cuda")


CARD_SPAN = (0.0, 100.0)


def _card(cuda):
    solver, w1 = cr_solver(dim=4, device=cuda)
    return solver, w1, (lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)])


def _batches(cuda, members, count=3):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1900)
    return [0.25 + 0.75 * torch.rand(members, generator=gen, dtype=torch.float64, device=cuda)
            for _ in range(count)]


def _eager(solver, fn, amps, **kw):
    options = dict(atol=1e-6, rtol=1e-6, max_steps=4096, h0=0.1, tile_b=512,
                   envelope_resolution=None, bucket_lanes=True, t_eval=None)
    options.update(kw)
    y0 = options.pop("y0", np.eye(16, dtype=complex)[0])
    with torch.no_grad():
        args, kwargs, collect = sweep_arguments(solver.model, fn, amps, CARD_SPAN, y0,
                                                rwa_signal_map=solver._rwa_signal_map, **options)
        return collect(asw.sweep_dopri5_lockstep(*args, **kwargs))


def _graph(solver, fn, amps, **kw):
    y0 = kw.pop("y0", np.eye(16, dtype=complex)[0])
    with torch.no_grad():
        return solver.solve_sweep(fn, amps, t_span=CARD_SPAN, y0=y0, method="fused_dopri5",
                                  atol=1e-6, rtol=1e-6, h0=0.1, **kw)


_CARD_CASES = {
    "constant": {},
    "t_eval": dict(t_eval=[0.0, 25.0, 61.5, 100.0]),
    "y0_2d": dict(y0=np.eye(16, dtype=complex)[:, :2]),
    "envelope_table": dict(envelope_resolution=64),
    "unbucketed": dict(bucket_lanes=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CARD_CASES))
def test_a_hit_is_bitwise_the_eager_path(cuda, clean, case):
    solver, w1, fn = _card(cuda)
    if case == "envelope_table":
        def fn(a):
            return [Signal(lambda t: a * 0.02 * torch.exp(-(((t - 50.0) / 20.0) ** 2)),
                           carrier_freq=w1)]
    metrics.enable_metrics()
    for i, amps in enumerate(_batches(cuda, 1000)):
        got = _graph(solver, fn, amps, **_CARD_CASES[case])
        want = _eager(solver, fn, amps, **_CARD_CASES[case])
        assert torch.equal(got, want), (case, i)
    counts = metrics.counters()
    assert counts.get("sweep.graph_misses") == 1 and counts.get("sweep.graph_hits") == 2
    assert "sweep.graph_fallbacks" not in counts


@pytest.mark.cuda
def test_hit_miss_and_fallback_counters(cuda, clean):
    solver, w1, fn = _card(cuda)
    amps = _batches(cuda, 1000, 1)[0]
    metrics.enable_metrics()

    def counts():
        c = metrics.counters()
        return tuple(c.get(f"sweep.graph_{n}", 0) for n in ("hits", "misses", "fallbacks"))

    _graph(solver, fn, amps)
    assert counts() == (0, 1, 0)
    _graph(solver, fn, amps)
    _graph(solver, fn, amps.clone())
    assert counts() == (2, 1, 0)
    _graph(solver, fn, amps[:900])  # another shape: a miss
    assert counts() == (2, 2, 0)
    # an input that requires grad (differentiable=False): the same detached
    # result from the graph as from the eager path, which runs without grad
    needs_grad = amps.clone().requires_grad_(True)
    got = _graph(solver, fn, needs_grad, differentiable=False)
    assert counts() == (3, 2, 0)
    assert torch.equal(got, _eager(solver, fn, amps)) and not got.requires_grad
    on_card = torch.tensor(w1, dtype=torch.float64, device=cuda)
    card_carrier = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=on_card)]  # noqa: E731
    for calls in (1, 2):
        got = _graph(solver, card_carrier, amps)
        assert counts() == (3, 2, calls)
    assert torch.equal(got, _eager(solver, card_carrier, amps))
    # a host constant envelope uploads at every call: a chain that
    # synchronizes, whose capture raises
    def held(a):
        return [Signal(lambda t: a * 0.02, carrier_freq=w1), Signal(0.0, carrier_freq=w1)]

    solver2, _ = cr_solver(dim=4, device=cuda)
    with torch.no_grad():
        y = solver2.solve_sweep(held, amps, t_span=CARD_SPAN, y0=np.eye(16, dtype=complex)[0],
                                method="fused_dopri5", atol=1e-6, rtol=1e-6, h0=0.1,
                                rwa_signal_map=lambda sigs: [sigs[0], sigs[1]])
    assert counts() == (3, 2, 3) and bool(torch.isfinite(y).all())
    # the card still runs graphs after the failed capture
    assert torch.equal(_graph(solver, fn, amps), _eager(solver, fn, amps))
    assert counts() == (4, 2, 3)


@pytest.mark.cuda
def test_a_carrier_change_replays_then_captures_anew(cuda, clean):
    """``signals_fn`` keeps its identity but its carrier moves: the call
    replays the key's latest graph, finds other carriers on the host and
    discards the replay for the eager chain and a new capture."""
    solver, w1, _ = _card(cuda)
    carrier = [w1]
    fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=carrier[0])]  # noqa: E731
    first, second = _batches(cuda, 1000, 2)
    metrics.enable_metrics()
    _graph(solver, fn, first)
    carrier[0] = w1 + 0.003
    got = _graph(solver, fn, second)
    assert torch.equal(got, _eager(solver, fn, second))
    again = _graph(solver, fn, first)
    assert torch.equal(again, _eager(solver, fn, first))
    counts = metrics.counters()
    assert counts["sweep.graph_misses"] == 2 and counts["sweep.graph_hits"] == 1


@pytest.mark.cuda
def test_a_phase_change_replays_then_captures_anew(cuda, clean):
    """As a carrier change: ``signals_fn`` keeps its identity but the phase
    it closes over moves. The phase's factor is baked into the graph, so
    the replay is discarded for the eager chain and a new capture."""
    solver, w1, _ = _card(cuda)
    phase = [0.0]
    fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1, phase=phase[0])]  # noqa: E731
    first, second = _batches(cuda, 1000, 2)
    metrics.enable_metrics()
    _graph(solver, fn, first)
    phase[0] = 0.7
    got = _graph(solver, fn, second)
    assert torch.equal(got, _eager(solver, fn, second))
    again = _graph(solver, fn, first)
    assert torch.equal(again, _eager(solver, fn, first))
    phase[0] = 0.0
    assert torch.equal(_graph(solver, fn, second), _eager(solver, fn, second))
    counts = metrics.counters()
    assert counts["sweep.graph_misses"] == 3 and counts["sweep.graph_hits"] == 1


@pytest.mark.cuda
def test_accepted_steps_per_engine_span_on_a_hit(cuda, clean):
    """A hit adds B1's steps once and records one ``sweep.engine`` span:
    the same accepted steps per span as the eager path."""
    solver, _, fn = _card(cuda)
    amps = _batches(cuda, 2048, 1)[0]
    _graph(solver, fn, amps)  # the key without counters
    metrics.enable_metrics()

    def per_span(call, repeats):
        metrics.reset_spans()
        for _ in range(repeats):
            call(solver, fn, amps)
        spans = [r for r in metrics.span_records() if r.name == "sweep.engine"]
        assert len(spans) == repeats and all("tile_b" in r.attrs for r in spans)
        return metrics.counters()["b1.steps_accepted"] / len(spans)

    eager = per_span(_eager, 2)
    _graph(solver, fn, amps)  # the miss of the counting key
    assert per_span(_graph, 3) == eager
    assert metrics.counters()["sweep.graph_hits"] == 3


@pytest.mark.cuda
def test_a_capture_launches_nothing_and_each_replay_counts_one(cuda, clean):
    """B1's launches, ``kernel.launches.adaptive_sweep_launch``: a miss runs
    the chain once (one launch) and captures it (none); each hit replays it
    (one), as the eager path counts its own."""
    solver, _, fn = _card(cuda)
    amps = _batches(cuda, 1000, 1)[0]
    metrics.enable_metrics()
    _graph(solver, fn, amps)
    assert launches("adaptive_sweep_launch") == 1
    for _ in range(2):
        _graph(solver, fn, amps)
    assert launches("adaptive_sweep_launch") == 3
    _eager(solver, fn, amps)
    assert launches("adaptive_sweep_launch") == 4
    counts = metrics.counters()
    assert counts["sweep.graph_misses"] == 1 and counts["sweep.graph_hits"] == 2


@pytest.mark.cuda
def test_a_result_survives_the_next_call(cuda, clean):
    solver, _, fn = _card(cuda)
    first, second = _batches(cuda, 1000, 2)
    _graph(solver, fn, first)
    y1 = _graph(solver, fn, first)
    kept = y1.clone()
    y2 = _graph(solver, fn, second)
    torch.cuda.synchronize()
    assert torch.equal(y1, kept) and not torch.equal(y1, y2)
