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
from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import rk_tableaus
from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw
from qiskit_dynamics_tpu_torch.ops import batched_linalg, chain_apply, df_sweep
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
    before = launches("adaptive_sweep_launch")
    args = (p["static"], p["ops"], p["omega"], p["freqs"], p["amps"], torch.as_tensor(p["y0"]))
    out = sweep_dopri5_lockstep(*args, tf=0.5, atol=TOL, rtol=TOL, tile_b=TILE_B)
    inputs = prepare_inputs(*args, tf=0.5, atol=TOL, rtol=TOL, tile_b=TILE_B)
    twin, traj, rec = sweep_dopri5_lockstep_plain(inputs)
    assert launches("adaptive_sweep_launch") == before
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


# ---------------------------------------------------------------------------
# the kernel's launch shape (pure; no card): every shape the wrapper can pick
# or a caller can force must be one the kernel takes
# ---------------------------------------------------------------------------
def _assert_valid(shape, n, k, tile_b):
    assert tile_b % shape.cluster == 0 and shape.cluster in asw.CLUSTER_SIZES
    assert shape.lanes & (shape.lanes - 1) == 0 and shape.lanes <= 32
    assert shape.lanes * shape.rows >= n and shape.rows in asw.MAX_THREADS
    assert shape.threads <= asw.MAX_THREADS[shape.rows] <= 1024
    assert shape.threads % shape.lanes == 0
    assert shape.threads // shape.lanes * shape.members_per_group == tile_b // shape.cluster
    assert 1 <= shape.stages_per_pass <= asw.STAGES
    assert shape.smem_bytes == asw.shared_bytes(n, k, shape.stages_per_pass, shape.threads,
                                                 shape.lanes)
    assert shape.smem_bytes <= asw.MAX_SHARED_BYTES


@pytest.mark.parametrize("tile_b", [4, 12, 256, 512])
@pytest.mark.parametrize("n", [1, 4, 9, 16, 27, 33, 64])
def test_launch_shape_invariants(n, tile_b):
    shape = asw.launch_shape(n, 2, tile_b)
    forced = [asw.shape_for(n, 2, tile_b, g) for g in asw.CLUSTER_SIZES if tile_b % g == 0]
    for s in [shape, *asw.candidate_shapes(n, 2, tile_b), *forced]:
        _assert_valid(s, n, 2, tile_b)
    for s in asw.candidate_shapes(n, 2, tile_b):
        assert s.members_per_group == 1


@pytest.mark.parametrize("k", [1, 3, 6])
def test_launch_shape_any_k(k):
    """The any-k instantiation keeps its coefficients in shared memory; the
    tables of fewer stages per pass where six do not fit."""
    for n in (4, 16, 40):
        _assert_valid(asw.launch_shape(n, k, 512), n, k, 512)
    assert asw.launch_shape(40, 6, 512).stages_per_pass < asw.STAGES


def test_launch_shape_main_row():
    """The main row (n = 16, k = 2, tile_b = 512): clusters of 16 blocks of 256
    threads, 8 lanes of 2 rows per member, all six stages' tables per pass
    (the fastest shape measured on the card)."""
    shape = asw.launch_shape(16, 2, 512)
    assert (shape.cluster, shape.lanes, shape.rows, shape.threads) == (16, 8, 2, 256)
    assert shape.members_per_group == 1 and shape.stages_per_pass == 6


def test_launch_shape_refuses():
    with pytest.raises(ValueError, match="n <= 64"):
        asw.launch_shape(65, 2, 512)
    with pytest.raises(ValueError, match="shared memory"):
        asw.launch_shape(64, 7, 512)  # one stage's tables take 262 KB
    with pytest.raises(ValueError, match="dividing tile_b"):
        asw.shape_for(16, 2, 12, 8)


def test_launch_constants_match_the_source():
    source = (_build.SOURCE_DIR / "adaptive_sweep.cu").read_text()
    assert f"kMaxN = {asw.MAX_N};" in source
    assert f"kMaxCluster = {max(asw.CLUSTER_SIZES)};" in source
    assert f"kStages = {asw.STAGES};" in source
    assert "return R >= 4 ? 512 : 1024;" in source
    assert asw.MAX_THREADS == {1: 1024, 2: 1024, 4: 512}


def test_df_sweep_kernel_for():
    """B8's two sweeps: the tensor-core one up to n = 32, one block per member
    above."""
    assert [df_sweep.kernel_for(n) for n in (1, 32, 33, 36, df_sweep.MAX_WIDE_N)] == [
        "dmma", "dmma", "wide", "wide", "wide"]


@pytest.mark.parametrize("source, constant, value", [
    ("df_magnus_sweep.cu", "kMaxN", df_sweep.MAX_N),
    ("df_magnus_wide.cu", "kWideMaxN", df_sweep.MAX_WIDE_N),
    ("df_magnus_wide.cu", "kMaxN", df_sweep.MAX_N),
    ("chain_apply.cu", "kMaxN", chain_apply.MAX_N),
    ("batched_linalg.cu", "kMaxN", batched_linalg.MAX_N),
])
def test_kernel_caps_match_the_source(source, constant, value):
    """Each wrapper's cap is its kernel's: no dimension below it is refused."""
    text = (_build.SOURCE_DIR / source).read_text()
    assert f"{constant} = {value};" in text


def test_no_cuda_route_to_the_plain_versions():
    """The ops take the plain version for CPU tensors only: another device
    gets no silent plain path."""
    meta = torch.zeros((65, 65, 2), device="meta")
    with pytest.raises(RuntimeError, match="no path for device meta"):
        batched_linalg.matmul_bol(meta, meta, meta, meta)
    props = torch.zeros((1, 65, 65, 2), dtype=torch.complex64, device="meta")
    with pytest.raises(RuntimeError, match="no path for device meta"):
        chain_apply.chain_apply_bol(props, torch.zeros((65, 2), dtype=torch.complex64,
                                                       device="meta"))
