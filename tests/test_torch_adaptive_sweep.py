"""Parity of the port's lockstep-adaptive dopri5 sweep (eager twin) with the
JAX package's Pallas kernel, run in interpret mode.

Model: ``cr_solver(dim=2)`` (n = 4, k = 2 RWA signal operators), B = 8 lanes
in tiles of 4, T = 2. Amplitudes come from a numpy seed. Tolerance choice:
both implementations run their state in float32, so the error estimate
carries f32 roundoff of about h|k| * 1e-8; at atol = rtol = 1e-3 that is
~1e-5 of the estimate and step sizes agree to ~1e-5, while at 1e-4 the
roundoff already moves steps by ~1e-4. The bars are the port's acceptance
criteria: final states within 2e-5, the same accepted-step count per tile,
step sizes within 1e-4 relative, NaN in exactly the tiles where JAX has NaN
(``torch_parity.step_records_agree`` says which steps f32 roundoff exempts).
"""
import re

import numpy as np
import pytest
import torch

from torch_parity import jax_kernel_data, rng, step_records_agree

from qiskit_dynamics_tpu.benchmarks import cr_solver as jax_cr_solver
from qiskit_dynamics_tpu.ops import rk_tableaus as jax_tableaus
from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep as jax_sweep
from qiskit_dynamics_tpu.solvers.fused_sweep import _expand_lanes as jax_expand_lanes

from qiskit_dynamics_tpu_torch.kernels import _build
from qiskit_dynamics_tpu_torch.ops import rk_tableaus
from qiskit_dynamics_tpu_torch.ops.adaptive_sweep import (
    prepare_inputs,
    sweep_dopri5_lockstep,
    sweep_dopri5_lockstep_plain,
)
from qiskit_dynamics_tpu_torch.solvers.fused_sweep import _expand_lanes

T = 2.0
B = 8
TILE_B = 4
TOL = 1e-3
N_CELLS = 8
EVAL_TS = (0.55, 1.3, 2.0)


@pytest.fixture(scope="module")
def problem():
    """Frame-basis operators of the JAX CR model and seeded lane data."""
    solver, w1 = jax_cr_solver(dim=2)
    static, ops, omega = jax_kernel_data(solver.model, (0.0, T))
    gen = rng(7)
    # tile 0 drives weakly, tile 1 strongly (distinct step counts per tile)
    radius = np.concatenate([gen.uniform(2.0, 4.0, 4), gen.uniform(8.0, 10.0, 4)])
    amp = radius * np.exp(1j * gen.uniform(0.0, 2 * np.pi, B))
    amps = np.stack([amp, amp * np.exp(-1j * np.pi / 2)])  # the RWA (cos, sin) pair
    cell_t = (np.arange(N_CELLS) + 0.5) * T / N_CELLS
    envelope = np.exp(-((cell_t - 1.0) ** 2))
    y0 = np.zeros((static.shape[0], B), dtype=complex)
    y0[0] = 1.0
    return dict(
        static=static, ops=ops, omega=omega, freqs=np.full(2, 2 * np.pi * w1),
        amps=amps, table=amps[:, None, :] * envelope[None, :, None], y0=y0,
    )


MODES = {
    "constant": {},
    "table": {"env_dt": T / N_CELLS},
    "table_eval": {"env_dt": T / N_CELLS, "eval_ts": EVAL_TS},
}


def _run_both(problem, mode, max_steps=512):
    p = problem
    amps = p["amps"] if mode == "constant" else p["table"]
    kwargs = dict(tf=T, atol=TOL, rtol=TOL, h0=0.1, tile_b=TILE_B, max_steps=max_steps,
                  record_steps=True, **MODES[mode])
    args = (p["static"], p["ops"], p["omega"], p["freqs"], amps)
    jax_out, jax_rec = jax_sweep(*args, p["y0"], interpret=True, **kwargs)
    port_out, port_rec = sweep_dopri5_lockstep(*args, torch.as_tensor(p["y0"]), **kwargs)
    return jax_out, np.asarray(jax_rec), port_out, port_rec.numpy()


@pytest.fixture(scope="module")
def runs(problem):
    return {mode: _run_both(problem, mode) for mode in MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_final_states_match_jax(runs, mode):
    jax_out, _, port_out, _ = runs[mode]
    if mode == "table_eval":
        jax_out, port_out = jax_out[0], port_out[0]
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_accepted_steps_match_jax(runs, mode):
    _, jax_rec, _, port_rec = runs[mode]
    assert port_rec.shape == jax_rec.shape
    boundaries = [T]
    if "env_dt" in MODES[mode]:
        boundaries += list(np.arange(1, N_CELLS) * T / N_CELLS)
    boundaries += list(MODES[mode].get("eval_ts", ()))
    failures = step_records_agree(jax_rec, port_rec, boundaries, rtol=1e-4)
    assert failures == [], failures


def test_trajectory_matches_jax(runs):
    jax_out, _, port_out, _ = runs["table_eval"]
    traj = port_out[1].numpy()
    assert traj.shape == (len(EVAL_TS), 4, B)
    np.testing.assert_allclose(traj, np.asarray(jax_out[1]), rtol=0, atol=2e-5)
    # the last eval time is tf: the trajectory ends on the final state
    np.testing.assert_array_equal(traj[-1], port_out[0].numpy())


def test_budget_exhaustion_poisons_the_same_tiles(problem):
    """A budget that the weak tile meets and the strong tile does not."""
    jax_out, _, port_out, _ = _run_both(problem, "constant", max_steps=40)
    jax_nan = np.isnan(np.asarray(jax_out)).reshape(4, 2, TILE_B).all(axis=(0, 2))
    port_nan = np.isnan(port_out.numpy()).reshape(4, 2, TILE_B).all(axis=(0, 2))
    np.testing.assert_array_equal(jax_nan, [False, True])
    np.testing.assert_array_equal(port_nan, jax_nan)
    np.testing.assert_allclose(
        port_out.numpy()[:, :TILE_B], np.asarray(jax_out)[:, :TILE_B], rtol=0, atol=2e-5
    )


@pytest.mark.parametrize("m", [1, 3])
def test_expand_lanes_matches_jax(m):
    """Padding lanes are copies of a real lane, laid out as in the JAX glue."""
    gen = rng(3)
    lane_data = gen.normal(size=(2, 5)) + 1j * gen.normal(size=(2, 5))
    y0 = gen.normal(size=(4,) if m == 1 else (4, m)) + 0j
    ref = jax_expand_lanes(lane_data, y0, 4, TILE_B)
    out = _expand_lanes(torch.as_tensor(lane_data), torch.as_tensor(y0), 4, TILE_B)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert out[2:] == tuple(ref[2:])
    assert out[0].shape[-1] % TILE_B == 0


def test_tableau_matches_jax_and_cuda_source():
    for name in ("DOPRI5_A", "DOPRI5_B", "DOPRI5_C", "DOPRI5_E"):
        np.testing.assert_array_equal(getattr(rk_tableaus, name), getattr(jax_tableaus, name))
    source = (_build.SOURCE_DIR / "adaptive_sweep.cu").read_text()

    def constants(symbol):
        body = re.search(rf"{symbol}(?:\[\d+\])+ = \{{(.*?)\}};", source, re.S).group(1)
        return np.array([float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", body)])

    np.testing.assert_array_equal(constants("kA"), rk_tableaus.DOPRI5_A.ravel())
    np.testing.assert_array_equal(constants("kB"), rk_tableaus.DOPRI5_B)
    np.testing.assert_array_equal(constants("kC"), rk_tableaus.DOPRI5_C)
    np.testing.assert_array_equal(constants("kE"), rk_tableaus.DOPRI5_E)


def test_cpu_tensors_take_the_twin(problem):
    """On CPU tensors the wrapper runs the eager twin and launches nothing."""
    p = problem
    before = sweep_dopri5_lockstep.launches
    args = (p["static"], p["ops"], p["omega"], p["freqs"], p["amps"], torch.as_tensor(p["y0"]))
    out = sweep_dopri5_lockstep(*args, tf=0.5, atol=TOL, rtol=TOL, tile_b=TILE_B)
    inputs = prepare_inputs(*args, tf=0.5, atol=TOL, rtol=TOL, tile_b=TILE_B)
    twin, traj, rec = sweep_dopri5_lockstep_plain(inputs)
    assert sweep_dopri5_lockstep.launches == before
    assert traj is None and rec is None
    np.testing.assert_array_equal(out.numpy(), twin.numpy())


@pytest.mark.parametrize(
    "change, message",
    [
        ({"tile_b": 3}, "multiple of tile_b"),
        ({"table": True}, "env_dt must be set"),
        ({"eval_ts": (0.5, 0.2)}, "strictly increasing"),
        ({"eval_ts": (0.5, 3.0)}, "must lie in"),
    ],
)
def test_invalid_arguments_raise(problem, change, message):
    p = problem
    change = dict(change)
    amps = p["table"] if change.pop("table", False) else p["amps"]
    kwargs = {"tf": T, "tile_b": TILE_B, **change}
    with pytest.raises(ValueError, match=message):
        sweep_dopri5_lockstep(
            p["static"], p["ops"], p["omega"], p["freqs"], amps, torch.as_tensor(p["y0"]),
            **kwargs,
        )
