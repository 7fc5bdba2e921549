"""BASELINE config 4 as the benchmark runs it: the cells ``dyson_sweep`` and
``magnus_sweep`` of ``transmon_dim10_dysolve``.

- ``DysonSolver`` and ``MagnusSolver.solve_sweep``, built from the
  configuration file by the benchmark's program, against the plain reference
  (``portbench/reference.py``, complex128, the exact solution on its fine
  grid) at the cells' tiny sizes on seeded amplitudes, and on a dim-4 model
  with a seeded random Hermitian drive operator;
- the work count ``portbench/counts/dysolve.py`` against a hand count and
  against the port's expansions (209 and 34 monomials at one drive);
- the readers ``dysolve_roofline_pct``, ``chain_roofline_pct`` and
  ``expm_roofline_pct`` on synthetic runs, and nothing read where their
  inputs are missing;
- the cells' entries: what each reports.

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
from portbench import program, reference, spec  # noqa: E402
from portbench.counts import dysolve, roofline  # noqa: E402
from portbench.model import Drive, Model  # noqa: E402
from portbench.programs import perturbative_sweep  # noqa: E402
from tiny import tiny_cell  # noqa: E402

CELLS = ("dyson_sweep", "magnus_sweep")
CPU = torch.device("cpu")


@pytest.fixture
def clean():
    metrics.disable_metrics(clear=True)
    yield
    metrics.disable_metrics(clear=True)


def _amps(seed, count):
    gen = torch.Generator().manual_seed(seed)
    return 0.2 + 0.8 * torch.rand(count, generator=gen, dtype=torch.float64)


def _program_and_reference(model, traffic, amps):
    """The program's final frame states and the reference's, complex128."""
    solver = perturbative_sweep.build_solver(model, traffic, CPU)
    steps = perturbative_sweep.steps(model, traffic)
    got = solver.solve_sweep(0.0, steps, model.y0, program.signals_fn(model), amps)
    ref = traffic["reference"]
    want = reference.solve(
        reference.Problem(model, CPU), amps, 0.0, model.t_final,
        reference.fixed_steps(model.t_final, float(ref["max_dt"])), int(ref["magnus_order"]),
        reference.Arith("float64"))
    return got, want


# At the tiny size (20 steps of 0.1, the Gaussian's sigma 1/3) the program
# runs in complex128 on the CPU, so its gap to the exact solution is the
# algorithm's own: the Chebyshev order-1 interpolant of the envelope over
# each step (the expansion orders leave ~1e-12 at this drive). It reads
# 5.1-5.2e-7 on these seeds; 5e-6 leaves room for other amplitudes and sits
# far below the cells' state_err limit of 3e-3, which a TF32 control exceeds.
TINY_TOL = 5e-6


@pytest.mark.parametrize("seed", [2**31 + 18, 2**31 + 1801])
@pytest.mark.parametrize("cell", CELLS)
def test_the_cells_solvers_agree_with_the_reference(cell, seed):
    c = tiny_cell(cell)
    model = model_mod.build(c.config)
    assert model.dim == 10 and c.traffic["options"]["expansion_method"] == cell.split("_")[0]
    got, want = _program_and_reference(model, c.traffic, _amps(seed, 3))
    assert got.dtype == torch.complex128 and got.shape == (3, 10)
    err = float((got - want).abs().max())
    assert err < TINY_TOL, err
    # the drive moves the state: the check is not of an idle evolution
    assert float((want[:, 1:]).abs().max()) > 1e-3


def _random_drive_model(seed, t_final=2.0):
    """A dim-4 model: a seeded diagonal H0 near a 5 GHz ladder, one drive of
    a seeded random Hermitian operator at 5 GHz under the cells' Gaussian."""
    gen = np.random.default_rng(seed)
    k = np.arange(4)
    levels = 2 * np.pi * (5.0 * k - 0.165 * k * (k - 1) + gen.uniform(-0.05, 0.05, 4))
    levels -= levels[0]
    a = gen.normal(size=(4, 4)) + 1j * gen.normal(size=(4, 4))
    herm = (a + a.conj().T) / 2
    operator = 2 * np.pi * 0.02 * herm / np.linalg.norm(herm, 2)
    y0 = np.zeros(4, dtype=complex)
    y0[0] = 1.0
    env = {"kind": "gaussian", "center": t_final / 2, "sigma": t_final / 6}
    return Model(static_hamiltonian=np.diag(levels).astype(complex),
                 drives=[Drive(operator=operator, carrier_ghz=5.0, envelope_scale=1.0,
                               envelope=env)],
                 dissipators=[], frame=levels, rwa_cutoff_ghz=None, vectorized=False, y0=y0,
                 t_final=t_final)


# The random operator couples every pair of levels, so the frame turns its
# entries at up to ~15 GHz against the 5 GHz carrier, and the error of the
# envelope's order-1 interpolant over a step no longer averages out as on
# the transmon's ladder: it reads 1.4e-5 and 1.9e-5 on these seeds (5.2e-7
# at Chebyshev order 2, 3.0e-6 at half the step: the interpolant's dt^2).
# 1e-4 keeps room above it and stays 30 times below the cells' limit.
RANDOM_TOL = 1e-4


@pytest.mark.parametrize("seed", [18, 1802])
@pytest.mark.parametrize("method, order", [("dyson", 6), ("magnus", 3)])
def test_a_random_hermitian_drive_agrees_with_the_reference(method, order, seed):
    model = _random_drive_model(seed)
    traffic = tiny_cell(f"{method}_sweep").traffic
    assert traffic["options"]["expansion_order"] == order
    got, want = _program_and_reference(model, traffic, _amps(seed, 4))
    err = float((got - want).abs().max())
    assert err < RANDOM_TOL, err
    assert float((want[:, 1:]).abs().max()) > 1e-3
    norms = (got.abs() ** 2).sum(-1)
    assert float((norms - 1).abs().max()) < 1e-10  # complex128: unitary to roundoff


# --- the work count -----------------------------------------------------------
def test_dysolve_count_by_hand_at_a_tiny_shape():
    # n = 2, one drive, Chebyshev order 1: 4 variables; order 2: the 14
    # multisets of 1 or 2 of them, 10 of degree 2 (one product each)
    base = dict(n=2, k=1, steps=3, members=2, chebyshev_order=1, expansion_order=2)
    lanes = 6
    # per lane: 10 products, 4 x 14 x 4 contraction, 8 x 4 chain
    dyson = (10 + 4 * 14 * 4 + 8 * 4) * lanes
    # float32 table 4 x 4 x 6, 14 complex64 matrices, y0, 2 final states
    dyson_bytes = 4 * 4 * 6 + 8 * 14 * 4 + 8 * 2 + 8 * 2 * 2
    assert dysolve.work(dict(base, expansion_method="dyson")) == (dyson, dyson_bytes)
    # Magnus adds 11 Horner products, one squaring and the Udt product
    # (13 x 8 n^3 a lane) and reads Udt
    magnus = dyson + 13 * 8 * 8 * lanes
    assert dysolve.work(dict(base, expansion_method="magnus")) == (magnus, dyson_bytes + 8 * 4)
    with pytest.raises(ValueError):
        dysolve.work(dict(base, expansion_method="taylor"))


@pytest.mark.parametrize("cell, terms, ms", [("dyson_sweep", 209, 2.586), ("magnus_sweep", 34, 3.62)])
def test_dysolve_count_at_the_cells_shape(cell, terms, ms):
    c = spec.load_cell(cell)
    model = model_mod.build(c.config)
    shape = perturbative_sweep.sweep_shape(model, c.traffic)
    assert shape == dict(n=10, k=1, steps=1000, members=2048,
                         expansion_method=cell.split("_")[0],
                         expansion_order=6 if cell == "dyson_sweep" else 3, chebyshev_order=1)
    assert dysolve.monomials(shape["expansion_order"], dysolve.variables(1, 1)) == terms
    seconds, by = roofline.bound(*dysolve.work(shape))
    assert by == "operations" and round(seconds * 1e3, 3) == ms


@pytest.mark.parametrize("method, order, terms", [("dyson", 6, 209), ("magnus", 3, 34)])
def test_dysolve_count_matches_the_ports_expansion(method, order, terms):
    """The count's terms and products are the port's: the expansion's
    monomial labels, and one product for each monomial formed from a lower
    one by the polynomial's product table."""
    from qiskit_dynamics_tpu_torch.benchmarks import dyson_transmon_solver, magnus_transmon_solver

    make = dyson_transmon_solver if method == "dyson" else magnus_transmon_solver
    solver, _ = make(device="cpu")
    poly = solver.model.expansion_polynomial
    assert len(poly.monomial_labels) == terms
    n_vars = dysolve.variables(1, 1)
    assert dysolve.monomials(order, n_vars) == terms
    products = sum(len(var) for parent, var in poly._levels if parent is not None)
    n = 10
    flops = dysolve.flops_per_lane(n, method, terms, n_vars)
    rest = 4 * terms * n * n + 8 * n * n + (13 * 8 * n**3 if method == "magnus" else 0)
    assert flops - rest == products == terms - n_vars


# --- the readers --------------------------------------------------------------
class _Run:
    """The parts of ``harness.Run`` the readers read."""

    def __init__(self, shape, trace, window_start=0.0):
        self._shape, self.trace, self.window_start = shape, trace, window_start
        self.members = shape["members"]
        self.entry = "forward"

    def sweep_shape(self):
        return dict(self._shape)


SHAPE = dict(n=10, k=1, steps=1000, members=2048, expansion_order=6, chebyshev_order=1)
B5 = "void (anonymous namespace)::chain_apply_kernel<float, 10, 3>(float2 const*, float2 const*"
B6 = "void (anonymous namespace)::expm_lane_kernel<10, float>(float const*, float const*, float"


def _reader(name):
    cell = spec.load_cell("magnus_sweep")
    (metric,) = [m for m in cell.per_layer if m.name == name]
    return metric.reader()


def _record_passes(method, terms, calls=2, lanes=2_048_000):
    metrics.enable_metrics()
    for _ in range(calls):
        with metrics.span("sweep.call"), metrics.span("sweep.engine", method=method, n=10,
                                                      monomials=terms, lanes=lanes):
            metrics.count("pert.step_lanes", lanes)
            metrics.count("pert.monomials", terms)


@pytest.mark.parametrize("method, terms, busy_ms", [("dyson", 209, 16.4), ("magnus", 34, 13.8)])
def test_dysolve_roofline_reader_arithmetic(clean, method, terms, busy_ms):
    _record_passes(method, terms)
    shape = dict(SHAPE, expansion_method=method)
    run = _Run(shape, dict(call_busy_s=2 * busy_ms * 1e-3, calls=2, device_ops=[]))
    least_s, _ = roofline.bound(*dysolve.work(dict(shape, expansion_order=6 if method == "dyson"
                                                   else 3)))
    got = _reader("dysolve_roofline_pct").read(run)
    assert got == pytest.approx(100 * least_s / (busy_ms * 1e-3), rel=1e-12)
    assert 10 < got < 30
    # a window that started after the passes holds none of them
    assert _reader("dysolve_roofline_pct").read(_Run(shape, run.trace, window_start=1e12)) is None


@pytest.mark.parametrize("name, ops, want_ms", [
    ("chain_roofline_pct", [[B5, 2 * 0.915e-3], ["Memcpy DtoD", 1.0]], 0.4892),
    ("expm_roofline_pct", [[B6, 2 * 5.651e-3], [B5, 2 * 0.915e-3]], 2.934),
])
def test_kernel_roofline_readers_arithmetic(name, ops, want_ms):
    shape = dict(SHAPE, expansion_method="magnus", expansion_order=3)
    run = _Run(shape, dict(call_busy_s=0.03, calls=2, device_ops=ops))
    got = _reader(name).read(run)
    kernel_ms = ops[0][1] / 2 * 1e3
    assert got == pytest.approx(100 * want_ms / kernel_ms, rel=2e-4)
    assert 45 < got < 60


@pytest.mark.parametrize("name", ["dysolve_roofline_pct", "chain_roofline_pct",
                                  "expm_roofline_pct"])
def test_readers_report_nothing_without_their_inputs(clean, monkeypatch, name):
    shape = dict(SHAPE, expansion_method="magnus", expansion_order=3)
    reader = _reader(name)
    # an untraced run; a trace with no calls or no device time
    assert reader.read(_Run(shape, None)) is None
    assert reader.read(_Run(shape, dict(call_busy_s=0.0, calls=0, device_ops=[]))) is None
    # a trace without the kernel, and a program that recorded no pass
    assert reader.read(_Run(shape, dict(call_busy_s=0.03, calls=2,
                                        device_ops=[["Memcpy DtoD", 1e-3]]))) is None
    # a program older than the spans and counters has neither API
    _record_passes("magnus", 34)
    for attr in ("span_records", "counters"):
        monkeypatch.delattr(metrics, attr)
    got = reader.read(_Run(shape, dict(call_busy_s=0.03, calls=2, device_ops=[])))
    assert got is None


def test_the_cells_report_their_metrics():
    want = {"launches_per_call.fwd", "device_idle_pct.fwd", "glue_host_ms.fwd",
            "dysolve_roofline_pct", "chain_roofline_pct"}
    for cell in CELLS:
        c = spec.load_cell(cell)
        assert c.chips == 1 and c.traffic["work"] == "dysolve"
        assert {m.name for m in c.end_to_end} == {"sims_per_s", "setup_s"}
        per_layer = {m.name for m in c.per_layer}
        assert per_layer == (want | {"expm_roofline_pct"} if cell == "magnus_sweep" else want)
        assert all(m.moves == "sims_per_s" for m in c.per_layer)
        assert c.config["name"] == "transmon_dim10_dysolve" and model_mod.build(c.config).dim == 10
    bench = spec.load_benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == "transmon_dim10_dysolve"]
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/transmon_dim10_dysolve.json"
