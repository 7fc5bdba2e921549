"""BASELINE config 3 on one damped 8-level transmon as the benchmark runs it:
the cell ``qudit_member_sweep`` of ``lindblad_qudit_dim8`` (solve dim 64).

- ``Solver.solve_sweep``, built by the benchmark's program from the
  configuration file at its published widths, against the plain reference
  (``portbench/reference.py``, complex128, the same Magnus-3 rule with the
  exact step propagator) at a tiny size on seeded amplitudes, and on a dim-8
  model with a seeded random Hermitian drive and a seeded random
  dissipator;
- that ``sweep_engine="auto"`` routes the cell to the member engine (kernel
  B3 on the card, its plain version here), with B3's ``sweep.engine``
  attributes and the counter ``member.step_lanes``;
- the work count ``portbench/counts/magnus_member.py`` against a hand count
  and against the bounds ``chip_smoke.py`` phase 9 printed at the cell's
  shape;
- the reader ``member_roofline_pct`` on a synthetic run, and nothing read
  where its inputs are missing;
- that the TF32 control (``portbench/control.py``) fails the cell's limits;
- the cell's entries: what it reports.

This file imports nothing of JAX.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "portbench" / "tests"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench import model as model_mod  # noqa: E402
from portbench import control, program, reference, spec  # noqa: E402
from portbench.counts import magnus_member, roofline  # noqa: E402
from portbench.model import Drive, Model  # noqa: E402
from tiny import run_tiny, tiny_cell  # noqa: E402

CELL = "qudit_member_sweep"
CPU = torch.device("cpu")
T_TINY = 0.5  # 10 steps of the cell's 0.05


@pytest.fixture
def clean():
    metrics.disable_metrics(clear=True)
    yield
    metrics.disable_metrics(clear=True)


def _amps(seed, count=4):
    gen = torch.Generator().manual_seed(seed)
    return 0.2 + 0.8 * torch.rand(count, generator=gen, dtype=torch.float64)


def _program_and_reference(model, traffic, amps):
    """The program's final frame density matrices and the reference's."""
    y, _ = program.Program(model, traffic, CPU).call(amps)
    ref = traffic["reference"]
    want = reference.solve(
        reference.Problem(model, CPU), amps, 0.0, model.t_final,
        reference.fixed_steps(model.t_final, float(ref["max_dt"])), int(ref["magnus_order"]),
        reference.Arith("float64"))
    return y.to(torch.complex128), want


# The plain version of the member engine runs the cell's arithmetic on the
# CPU: float32 coefficients, complex64 generators, brackets and Horner action
# (B3's products are 3xTF32 on the card, float32-level too). Over 10 steps it
# reads 7.3e-8 and 2.5e-8 from the complex128 reference on these seeds; 1e-6
# leaves room for float32 roundoff at other amplitudes, and TF32 products (the
# control's arithmetic) read 8e-4 at this size.
TINY_TOL = 1e-6


@pytest.mark.parametrize("seed", [2**31 + 23, 2**31 + 2301])
def test_the_cells_solver_agrees_with_the_reference(seed):
    c = tiny_cell(CELL, t_final=T_TINY)
    model = model_mod.build(c.config)
    assert model.dim == 8 and model.vectorized and c.config["solve_dim"] == 64
    got, want = _program_and_reference(model, c.traffic, _amps(seed))
    assert got.shape == (4, 8, 8)
    err = float((got - want).abs().max())
    assert err < TINY_TOL, err
    # the drive moves the state: the check is not of an idle evolution
    assert float((want - torch.as_tensor(model.y0)).abs().max()) > 1e-2


def _random_model(seed, t_final=T_TINY):
    """A dim-8 model: a seeded diagonal H0 near the transmon's ladder, one
    drive of a seeded random Hermitian operator at 5 GHz, one seeded random
    dissipator, vectorized, from |1><1|."""
    gen = np.random.default_rng(seed)
    k = np.arange(8)
    levels = 2 * np.pi * (5.0 * k - 0.165 * k * (k - 1) + gen.uniform(-0.05, 0.05, 8))
    a = gen.normal(size=(8, 8)) + 1j * gen.normal(size=(8, 8))
    herm = (a + a.conj().T) / 2
    operator = 2 * np.pi * 0.02 * herm / np.linalg.norm(herm, 2)
    L = gen.normal(size=(8, 8)) + 1j * gen.normal(size=(8, 8))
    L = 0.1 * L / np.linalg.norm(L, 2)
    rho0 = np.zeros((8, 8), dtype=complex)
    rho0[1, 1] = 1.0
    return Model(static_hamiltonian=np.diag(levels).astype(complex),
                 drives=[Drive(operator=operator, carrier_ghz=5.0, envelope_scale=1.0)],
                 dissipators=[L], frame=levels, rwa_cutoff_ghz=None, vectorized=True, y0=rho0,
                 t_final=t_final)


# The random operator couples every pair of levels and the random
# dissipator every pair of entries of the density matrix, so every entry of
# the 64 x 64 generator is live: float32 roundoff reads 5.3e-8 and 5.1e-8 on
# these seeds, and 1e-6 keeps the room of the test above.
@pytest.mark.parametrize("seed", [23, 2302])
def test_a_random_drive_and_dissipator_agree_with_the_reference(seed):
    model = _random_model(seed)
    traffic = tiny_cell(CELL).traffic
    got, want = _program_and_reference(model, traffic, _amps(seed))
    err = float((got - want).abs().max())
    assert err < TINY_TOL, err
    assert float((want - torch.as_tensor(model.y0)).abs().max()) > 1e-3
    traces = torch.diagonal(got, dim1=-2, dim2=-1).sum(-1)
    assert float((traces - 1).abs().max()) < 1e-6  # the Lindbladian keeps the trace


def test_auto_routes_to_the_member_engine_and_counts_its_lanes(clean):
    c = tiny_cell(CELL, t_final=T_TINY)
    assert "sweep_engine" not in c.traffic["options"]  # left at "auto"
    model = model_mod.build(c.config)
    metrics.enable_metrics()
    prog = program.Program(model, c.traffic, CPU)
    for seed in (1, 2):
        prog.call(_amps(seed))
    records = metrics.span_records()
    calls = [r for r in records if r.name == "sweep.call"]
    assert [r.attrs["engine"] for r in calls] == ["member", "member"]
    engines = [r for r in records if r.name == "sweep.engine"]
    steps = reference.fixed_steps(T_TINY, c.traffic["options"]["max_dt"])
    assert steps == 10
    assert [r.attrs for r in engines] == 2 * [dict(n=64, k=1, magnus=3, hermitian=False,
                                                   steps=steps, members=4)]
    assert {r.call for r in engines} == {r.id for r in calls}
    assert metrics.counters()["member.step_lanes"] == 2 * steps * 4


def test_off_counts_no_lanes(clean):
    c = tiny_cell(CELL, t_final=0.1)
    program.Program(model_mod.build(c.config), c.traffic, CPU).call(_amps(3))
    assert "member.step_lanes" not in metrics.counters() and metrics.span_records() == []


# --- the work count -----------------------------------------------------------
def test_member_count_by_hand_at_a_tiny_shape():
    shape = dict(n=2, k=1, order=3, steps=5, members=4, magnus_order=3, hermitian=False)
    lanes = 20
    # per lane: 6 complex products of 8 n^3; Horner 3 x 8 n^2, the generators
    # 3 x 4 k n^2, the Magnus-3 assembly 40 n^2; per step the rotated tables
    # 3 x (k + 1) x 6 n^2
    products = 6 * 8 * 8 * lanes
    other = (3 * 8 * 4 + 3 * 4 * 4 + 40 * 4) * lanes + 5 * 3 * 2 * 6 * 4
    # float32 coefficients, the initial and final states, the tables and phases
    nbytes = 4 * 5 * 3 * 4 + 16 * 2 * 4 + 8 * 2 * 4 + 8 * 4
    assert magnus_member.counts(shape) == (products, other, nbytes)
    assert magnus_member.work(shape) == (products + other, nbytes)
    seconds, _ = magnus_member.tf32x3(shape)
    ops_s = (3 * products / roofline.PEAK_TF32 * roofline.PEAK_F32 + other) / roofline.PEAK_F32
    assert seconds == pytest.approx(max(ops_s, nbytes / roofline.PEAK_BYTES), rel=1e-12)
    # Magnus-2: one product with hermitian, two otherwise, and 8 n^2 assembly
    for hermitian, count in ((True, 1), (False, 2)):
        m2 = dict(shape, magnus_order=2, hermitian=hermitian)
        assert magnus_member.counts(m2)[0] == count * 8 * 8 * lanes
    with pytest.raises(ValueError):
        magnus_member.counts(dict(shape, magnus_order=4))


def test_member_count_gives_b3s_recorded_bounds():
    # chip_smoke.py phase 9 printed B3's bounds at this shape (PERF.md §6,
    # row B3): 341.4 ms with the products in 3xTF32, 798.3 ms at FP32, both
    # bound by the operations
    c = spec.load_cell(CELL)
    model = model_mod.build(c.config)
    opts = c.traffic["options"]
    shape = dict(n=64, k=1, order=opts["expm_order"], magnus_order=opts["magnus_order"],
                 steps=reference.fixed_steps(model.t_final, opts["max_dt"]),
                 members=c.traffic["members"], hermitian=False)
    assert shape["steps"] == 400 and shape["members"] == 10_240
    seconds, by = magnus_member.tf32x3(shape)
    assert by == "operations" and round(seconds * 1e3, 1) == 341.4
    seconds, by = roofline.bound(*magnus_member.work(shape))
    assert by == "operations" and round(seconds * 1e3, 1) == 798.3


# --- the reader ---------------------------------------------------------------
class _Run:
    """The parts of ``harness.Run`` the reader reads."""

    def __init__(self, trace, window_start=0.0, order=8):
        self.trace, self.window_start, self.order = trace, window_start, order
        self.entry = "forward"

    def sweep_shape(self):
        return dict(n=64, k=1, order=self.order, magnus_order=3, steps=400, members=10_240,
                    hermitian=False)


B3 = "void (anonymous namespace)::member_sweep_kernel<true>((anonymous namespace)::SweepParams)"
TABLES = "void (anonymous namespace)::member_tables_kernel((anonymous namespace)::TableParams)"
ATTRS = dict(n=64, k=1, magnus=3, hermitian=False, steps=400, members=10_240)


def _reader():
    (metric,) = [m for m in spec.load_cell(CELL).per_layer if m.name == "member_roofline_pct"]
    return metric.reader()


def _record_passes(calls=2, attrs=ATTRS):
    metrics.enable_metrics()
    for _ in range(calls):
        with metrics.span("sweep.call"), metrics.span("sweep.engine", **attrs):
            metrics.count("member.step_lanes", attrs["steps"] * attrs["members"])


def test_member_roofline_reader_arithmetic(clean):
    _record_passes()
    ops = [[B3, 2 * 1.0985], [TABLES, 2 * 0.0005], ["Memcpy DtoD", 1.0]]
    run = _Run(dict(call_busy_s=2 * 1.1, calls=2, device_ops=ops))
    got = _reader().read(run)
    assert got == pytest.approx(100 * 341.4 / 1099.0, rel=2e-4)
    # a window that started after the passes holds none of them
    assert _reader().read(_Run(run.trace, window_start=1e12)) is None


def test_member_roofline_reader_scales_with_the_counted_lanes(clean):
    # two passes a call (the counter counts both, the spans give one pass's
    # shape): twice the work over the same kernel time
    _record_passes(calls=4)
    ops = [[B3, 2 * 1.0985], [TABLES, 2 * 0.0005]]
    got = _reader().read(_Run(dict(call_busy_s=2.2, calls=2, device_ops=ops)))
    assert got == pytest.approx(2 * 100 * 341.4 / 1099.0, rel=2e-4)


def test_member_roofline_reader_reports_nothing_without_its_inputs(clean, monkeypatch):
    reader = _reader()
    ops = [[B3, 2.2]]
    # an untraced run; a trace with no calls; a trace without B3
    assert reader.read(_Run(None)) is None
    assert reader.read(_Run(dict(call_busy_s=0.0, calls=0, device_ops=[]))) is None
    assert reader.read(_Run(dict(call_busy_s=2.2, calls=2,
                                 device_ops=[["Memcpy DtoD", 1e-3]]))) is None
    # a program that recorded no pass, or passes without B3's attributes (a
    # program older than them) and no counter
    assert reader.read(_Run(dict(call_busy_s=2.2, calls=2, device_ops=ops))) is None
    metrics.enable_metrics()
    with metrics.span("sweep.call"), metrics.span("sweep.engine"):
        pass
    assert reader.read(_Run(dict(call_busy_s=2.2, calls=2, device_ops=ops))) is None
    # a program without the tracing API at all
    _record_passes()
    for attr in ("span_records", "counters"):
        monkeypatch.delattr(metrics, attr)
    assert reader.read(_Run(dict(call_busy_s=2.2, calls=2, device_ops=ops))) is None


def test_a_tiny_traced_run_of_the_cell(clean):
    c = tiny_cell(CELL, t_final=T_TINY)
    result = run_tiny(c, traced=True)
    assert result["correct"]
    assert result["checks"]["state_err"]["value"] < TINY_TOL
    got = result["metrics"]
    assert 0 < got["glue_host_ms.fwd"]["value"] < 1e4
    calls = metrics.span_totals()["sweep.call"]["count"]
    assert calls == result["attempted"]
    assert metrics.counters()["member.step_lanes"] == calls * 10 * c.traffic["members"]
    # a CPU run has no kernel in its trace: no roofline share
    assert "member_roofline_pct" not in got


def test_the_tf32_control_fails_the_cells_limits():
    # the reference in TF32 products (the precision below the configuration's
    # 3xTF32) over every one of the cell's 400 steps, at two members: it reads
    # ~0.05 in both numbers here (0.030-0.054 and 0.060 on the card at the
    # cell's size), far above the limits the program meets
    c = spec.load_cell(CELL)
    c.traffic.update(members=2, probes=2)
    row = control.read_side(c, model_mod.build(c.config), 2**31 + 101, CPU, "control")
    limits = c.traffic["limits"]
    assert all(row[name] > 10 * limits[name] for name in limits), row


# --- the cell's entries -------------------------------------------------------
def test_the_cell_reports_its_metrics():
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.traffic["work"] == "magnus_member"
    assert c.traffic["method"] == "fused_magnus2" and c.traffic["entry"] == "forward"
    assert c.traffic["options"] == dict(max_dt=0.05, magnus_order=3, expm_order=8)
    assert c.traffic["reference"] == dict(magnus_order=3, max_dt=0.05)
    assert {m.name for m in c.end_to_end} == {"sims_per_s", "setup_s"}
    assert {m.name for m in c.per_layer} == {"launches_per_call.fwd", "device_idle_pct.fwd",
                                             "glue_host_ms.fwd", "member_roofline_pct"}
    assert all(m.moves == "sims_per_s" for m in c.per_layer)
    assert c.config["name"] == "lindblad_qudit_dim8"
    assert "3xTF32" in c.config["precision"] and "single-pass TF32" in c.config["precision"]
    bench = spec.load_benchmark()
    (entry,) = [e for e in bench["configs"] if e["name"] == "lindblad_qudit_dim8"]
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/lindblad_qudit_dim8.json"
    assert len(entry["source"]) <= 200
    (member,) = [m for m in bench["per_layer"] if m["name"] == "member_roofline_pct"]
    assert member["workloads"] == [CELL] and member["layer"] == "kernels: ops/member_sweep.py (B3)"
