"""What decides ``correct``: the port agrees with the reference at a tiny
size, the TF32 control does not, and a run with the timed path broken
underneath reads ``correct`` false; the reference itself against scipy's
DOP853, and unchanged where a drive has no envelope."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control, reference, spec
from portbench import model as model_mod
from tiny import DYSON_ENTRIES, GRAD_ENTRIES, TINY, copy_with, run_tiny, tiny_cell

LISTED = [w["name"] for w in spec.load_benchmark()["workloads"]]
# cells not in BENCHMARK.json yet, by the entries that add them
ENTRIES = {w["name"]: entries for entries in (GRAD_ENTRIES, DYSON_ENTRIES)
           for w in entries["workloads"]}
CELLS = LISTED + list(ENTRIES)


@pytest.fixture
def cell_root(tmp_path):
    """The benchmark's root, or a copy with the entries that add the cell."""
    def root(cell):
        return spec.ROOT if cell in LISTED else copy_with(tmp_path, ENTRIES[cell])
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_plain_versions_agree_with_the_reference(cell, cell_root):
    result = run_tiny(tiny_cell(cell, root=cell_root(cell)))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


# The control at a size a CPU test run holds: a few members, but every step
# of the cell (TF32's error grows with the steps), and at n = 256 fewer.
CONTROL_SIZE = {"cr_amp_sweep": 4, "cr_fixed_sweep": 16, "cr_grad_sweep": 8,
                "cr_pair_open_sweep": 2, "dyson_sweep": 4, "magnus_sweep": 4}


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_limits(cell, cell_root):
    c = spec.load_cell(cell, cell_root(cell))
    c.traffic.update(members=CONTROL_SIZE[cell], probes=CONTROL_SIZE[cell])
    model = model_mod.build(c.config)
    row = control.read_side(c, model, 2**31 + 101, torch.device("cpu"), "control")
    limits = c.traffic["limits"]
    assert any(row[name] > limits[name] for name in limits), row


def _unchanged(call):
    """The state returned unchanged: every member's final state is y0."""
    def broken(amps):
        y, g = call(amps)
        flat = torch.zeros_like(y).reshape(len(y), -1)
        flat[:, 0] = 1.0  # a basis state, as the configurations start in
        return flat.reshape(y.shape), None if g is None else torch.zeros_like(g)
    return broken


def _half_batch(call):
    """Half the batch left out, the mean taken over the rest."""
    def broken(amps):
        h = amps.shape[0] // 2
        y, g = call(amps[:h])
        rest = torch.zeros((amps.shape[0] - h,) + tuple(y.shape[1:]), dtype=y.dtype)
        g_rest = None if g is None else torch.zeros(amps.shape[0] - h, dtype=g.dtype)
        return torch.cat([y, rest]), None if g is None else torch.cat([g, g_rest])
    return broken


def _altered(call):
    """One answer altered where it is produced: a member's first amplitude."""
    def broken(amps):
        y, g = call(amps)
        flat = y.detach().reshape(len(y), -1).clone()
        flat[len(y) // 3, 0] += 1e-2
        return flat.reshape(y.shape), g
    return broken


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_incorrect(cell, fault, cell_root):
    # one chip: no exchange between chips to leave out
    result = run_tiny(tiny_cell(cell, root=cell_root(cell)), wrap=FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_on_the_card_the_control_fails_and_the_program_passes(cell):
    """At the cell's own size on three seeds (``portbench/control.py``)."""
    seeds = [2**31 + 9001, 2**31 + 9002, 2**31 + 9003]
    limits = spec.load_cell(cell).traffic["limits"]
    for side, fails in (("control", True), ("program", False)):
        out = subprocess.run(
            [sys.executable, "portbench/control.py", "--workload", cell, "--side", side,
             "--seeds", ",".join(map(str, seeds))],
            cwd=spec.ROOT, capture_output=True, text=True, timeout=1800)
        assert out.returncode == 0, out.stderr[-3000:]
        rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        assert len(rows) == len(seeds)
        for row in rows:
            over = any(row[name] > limits[name] for name in limits)
            assert over == fails, row


def test_tiny_sizes_cover_every_cell():
    assert set(TINY) == set(CELLS)


def test_the_gaussian_reference_is_the_exact_solution(tmp_path):
    """At a tiny size, the reference on its grid against scipy's DOP853 at
    atol = rtol = 1e-12 on the lab-frame generator, taken into the frame."""
    from scipy.integrate import solve_ivp

    cell = tiny_cell("dyson_sweep", root=copy_with(tmp_path, DYSON_ENTRIES))
    model = model_mod.build(cell.config)
    ref = cell.traffic["reference"]
    T = model.t_final
    amps = torch.tensor([0.2, 0.65, 1.0], dtype=torch.float64)
    got = reference.solve(reference.Problem(model, torch.device("cpu")), amps, 0.0, T,
                          reference.fixed_steps(T, float(ref["max_dt"])),
                          int(ref["magnus_order"]), reference.Arith("float64")).numpy()
    (drive,) = model.drives
    env = drive.envelope
    for amp, row in zip(amps.tolist(), got):
        def rhs(t, y, amp=amp):
            f = amp * drive.envelope_scale * np.exp(-(t - env["center"]) ** 2
                                                    / (2 * env["sigma"] ** 2))
            h = model.static_hamiltonian + np.real(
                f * np.exp(2j * np.pi * drive.carrier_ghz * t)) * drive.operator
            return -1j * (h @ y)

        sol = solve_ivp(rhs, (0.0, T), model.y0, method="DOP853", atol=1e-12, rtol=1e-12)
        want = np.exp(1j * model.frame * T) * sol.y[:, -1]
        assert np.abs(row - want).max() < 1e-9


@pytest.mark.parametrize("cell", LISTED)
def test_without_an_envelope_the_reference_pieces_are_unchanged(cell):
    """``Problem.pieces`` bit for bit as it was before drives had
    envelopes, at the node times of the cell's reference grid."""
    c = spec.load_cell(cell)
    model = model_mod.build(c.config)
    problem = reference.Problem(model, torch.device("cpu"))
    dt = float(c.traffic["reference"]["max_dt"])
    nodes = torch.tensor(reference.GAUSS3, dtype=torch.float64)
    t = dt * (torch.arange(0, 400, 37, dtype=torch.float64)[:, None] + nodes)
    x, y = problem.pieces(t)
    phase = torch.exp(1j * problem.delta * t[..., None, None])
    want = torch.zeros_like(x)
    for nu, scale, plus, minus in zip(problem.nus, problem.scales, problem.plus, problem.minus):
        carrier = torch.exp(1j * nu * t)[..., None, None]
        want = want + (0.5 * scale) * (carrier * plus + carrier.conj() * minus)
    assert torch.equal(x, problem.static * phase) and torch.equal(y, want * phase)


@pytest.mark.parametrize("cell", ["dyson_sweep", "magnus_sweep"])
def test_the_perturbative_gradient_agrees_with_the_reference(cell, cell_root):
    """The value-and-gradient entry through the perturbative program, held
    to the gradient cell's limit (at 20 steps of a Gaussian of sigma 1/3 the
    Chebyshev interpolant of order 1 costs the gradient ~2e-5)."""
    c = tiny_cell(cell, root=cell_root(cell))
    c.traffic.update(entry="value_and_grad", loss_index=1)
    c.traffic["limits"]["grad_err"] = 1e-3
    result = run_tiny(c)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"state_err", "grad_err", "norm_err"}


def test_an_envelope_reaches_the_fused_solver():
    """A drive's envelope on the default program's path: a Gaussian on the
    fixed-step CR cell, at a tiny size."""
    c = tiny_cell("cr_fixed_sweep")
    T = c.config["t_final"]
    c.config["drives"][0]["envelope"] = {"kind": "gaussian", "center": T / 2, "sigma": T / 6}
    result = run_tiny(c)
    assert result["correct"], result["checks"]
    flat = run_tiny(tiny_cell("cr_fixed_sweep"))
    assert result["checks"]["state_err"]["value"] != flat["checks"]["state_err"]["value"]


@pytest.mark.parametrize("change", [dict(rwa_cutoff_ghz=5.05), dict(damping_rates=[0.005]),
                                    dict(freqs_ghz=[5.0, 5.1], anharmonicities_ghz=[-0.33, -0.33],
                                         coupling_ghz=0.002, levels=3)])
def test_the_perturbative_program_refuses_what_it_cannot_solve(change, tmp_path):
    from portbench.programs import perturbative_sweep

    c = tiny_cell("dyson_sweep", root=copy_with(tmp_path, DYSON_ENTRIES))
    c.config.update(change)
    with pytest.raises(ValueError):
        perturbative_sweep.build_solver(model_mod.build(c.config), c.traffic,
                                        torch.device("cpu"))


def test_a_program_module_gives_the_work_shape(tmp_path):
    """``Run.sweep_shape`` defers to the program module's ``sweep_shape``:
    a perturbative cell steps by the solver's ``dt``, not a ``max_dt``."""
    from portbench import harness
    from portbench.programs import perturbative_sweep

    c = tiny_cell("dyson_sweep", root=copy_with(tmp_path, DYSON_ENTRIES))
    model = model_mod.build(c.config)
    run = harness.Run(c, model, 0.0, 0.0, [], {}, None,
                      shape=harness.program_module(c.traffic).sweep_shape)
    assert run.sweep_shape() == dict(n=10, k=1, steps=20, members=3, expansion_method="dyson",
                                     expansion_order=6, chebyshev_order=1)
    model.t_final = 2.05  # not a whole number of steps of 0.1
    with pytest.raises(ValueError):
        perturbative_sweep.steps(model, c.traffic)
