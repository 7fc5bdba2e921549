"""Parity of the port's native-FP64 Magnus sweep (kernel B8's plain version)
with the JAX package's double-float32 XLA engine, ``ops/df_sweep.py``.

The JAX engine runs with ``fast_commutators=False, horner_df_tail=0`` (full
double-float32, unit roundoff ~2^-48); the port runs the same step rules in
float64. Tolerance 1e-12 on unit-norm states: both carry ~1e-14 per step over
40 steps; they differ in rounding only (df32 against float64, and the JAX
engine forms its frame phases as phasor products).

Cases: Magnus-2 and Magnus-3; a scalar and a per-step ``dt``; trajectory
slots; ``hermitian`` on and off; both forms of ``coef_factors``. The JAX
engine compiles once per (order, hermitian, slots) configuration, so the
cases share four configurations (~40 s of compiles).
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_rel_close, random_hermitian, rng

from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES as JAX_NODES
from qiskit_dynamics_tpu.ops.df_sweep import sweep_expm_magnus_df as jax_df

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs

B8 = ("df_magnus_sweep_launch", "df_magnus_wide_launch")  # kernel B8's two sweeps

N, K, R, B, T = 4, 2, 2, 8, 40
T0 = 0.5
SLOTS = tuple(-1 if s % 13 else s // 13 - 1 for s in range(1, T + 1))  # after steps 13, 26, 39


@pytest.fixture(scope="module")
def problem():
    """Seeded anti-Hermitian frame-basis operators, an antisymmetric frame
    matrix, per-member amplitudes, carriers and a complex profile, a
    non-uniform grid and normalized states."""
    gen = rng(501)
    y0 = gen.normal(size=(N, B)) + 1j * gen.normal(size=(N, B))
    omega = gen.normal(size=(N, N)) * 0.5
    return dict(
        static=-0.3j * random_hermitian(gen, N),
        ops=np.stack([-0.1j * random_hermitian(gen, N) for _ in range(K)]),
        omega=omega - omega.T,
        amps=gen.normal(size=(K, R, B)) + 1j * gen.normal(size=(K, R, B)),
        carriers=gen.uniform(0.2, 1.5, size=(K, R)),
        profile={nn: gen.normal(size=(T, nn, K, R)) + 1j * gen.normal(size=(T, nn, K, R))
                 for nn in (2, 3)},
        dts=0.05 * (1.0 + 0.5 * np.sin(np.arange(T))),
        y0=y0 / np.linalg.norm(y0, axis=0),
    )


def _coefficients(p, magnus_order, dts):
    """The table (T, n_nodes, k, B) of the carriers' factors at the nodes."""
    dts = np.broadcast_to(dts, (T,))
    t_start = T0 + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    tau = t_start[:, None] + dts[:, None] * JAX_NODES[magnus_order][None, :]
    waves = np.exp(2j * np.pi * p["carriers"][None, None] * tau[:, :, None, None])
    return np.real(np.einsum("tgjr,jrb->tgjb", waves, p["amps"]))


# (magnus_order, hermitian, eval_slots, dt form, coefficient form)
CASES = [
    (2, False, None, "scalar", "table"),
    (2, False, None, "per_step", "carriers"),
    (2, True, SLOTS, "per_step", "table"),
    (2, True, SLOTS, "per_step", "profile"),
    (3, False, None, "scalar", "table"),
    (3, True, SLOTS, "scalar", "table"),
    (3, True, SLOTS, "per_step", "carriers"),
    (3, True, SLOTS, "per_step", "profile"),
]


@pytest.mark.parametrize("magnus_order, hermitian, eval_slots, dt_form, coef_form", CASES)
def test_plain_matches_jax_xla(problem, magnus_order, hermitian, eval_slots, dt_form, coef_form):
    p = problem
    dt = 0.05 if dt_form == "scalar" else p["dts"]
    coefficients, factors = None, None
    if coef_form == "table":
        coefficients = _coefficients(p, magnus_order, dt)
    elif coef_form == "carriers":
        factors = (p["amps"], p["carriers"])
    else:
        factors = (p["amps"], p["profile"][len(JAX_NODES[magnus_order])])
    kwargs = dict(dt=dt, t0=T0, magnus_order=magnus_order, hermitian=hermitian,
                  coef_factors=factors, eval_slots=eval_slots)
    args = (p["static"], p["ops"], p["omega"], coefficients)
    expected = jax_df(*args, p["y0"], chunk_b=B, fast_commutators=False, horner_df_tail=0,
                      **kwargs)
    before = launches(*B8)
    out = dfs.sweep_expm_magnus_df(*args, torch.as_tensor(p["y0"]), chunk_b=3, **kwargs)
    assert launches(*B8) == before  # CPU tensors: the plain version
    if eval_slots is None:
        out, expected = (out,), (expected,)
    for got, want in zip(out, expected):
        assert got.dtype == torch.complex128 and got.device.type == "cpu"
        assert_rel_close(got, np.asarray(want), 1e-12)


def test_factor_table_matches_full_table(problem):
    """``coef_factors`` with carriers forms the table the caller would pass."""
    p = problem
    inputs = dfs.prepare_df_inputs(
        p["static"], p["ops"], p["omega"], None, torch.as_tensor(p["y0"]), p["dts"], t0=T0,
        coef_factors=(p["amps"], p["carriers"]),
    )
    assert_rel_close(inputs.coef, _coefficients(p, 3, p["dts"]), 1e-13)


def test_no_op_keywords_and_pallas_entry_point(problem):
    """``fast_commutators`` and ``horner_df_tail`` change nothing (all of it is
    FP64); the Pallas entry point is the same launch on a uniform grid."""
    p = problem
    coef = _coefficients(p, 3, 0.05)
    args = (p["static"], p["ops"], p["omega"], coef, torch.as_tensor(p["y0"]))
    base = dfs.sweep_expm_magnus_df(*args, dt=0.05, t0=T0)
    for kwargs in ({"fast_commutators": False}, {"horner_df_tail": 0}):
        assert torch.equal(dfs.sweep_expm_magnus_df(*args, dt=0.05, t0=T0, **kwargs), base)
    assert torch.equal(dfs.sweep_expm_magnus_df_pallas(*args, dt=0.05, t0=T0), base)


@pytest.mark.parametrize(
    "change, error, message",
    [({"magnus_order": 4}, ValueError, "magnus_order"),
     ({"devices": ["cuda:0"]}, NotImplementedError, "A13"),
     ({"eval_slots": (0, 0) + (-1,) * (T - 2)}, ValueError, "permutation"),
     ({"dt": np.full(T + 1, 0.05)}, ValueError, "dt must be"),
     ({"chunk_b": 0}, ValueError, "chunk_b"),
     ({"coef_factors": "both"}, ValueError, "either coefficients or coef_factors")],
)
def test_validation(problem, change, error, message):
    p = problem
    kwargs = {"dt": 0.05, "t0": T0, **change}
    if kwargs.get("coef_factors") == "both":
        kwargs["coef_factors"] = (p["amps"], p["carriers"])
    with pytest.raises(error, match=message):
        dfs.sweep_expm_magnus_df(p["static"], p["ops"], p["omega"], _coefficients(p, 3, 0.05),
                                 torch.as_tensor(p["y0"]), **kwargs)


def test_kernel_source_matches_wrapper():
    """The kernel's step constants come from the wrapper's float64 table; its
    limits are the wrapper's, and its products run on the FP64 tensor cores."""
    from qiskit_dynamics_tpu_torch.kernels import _build

    source = (_build.SOURCE_DIR / "df_magnus_sweep.cu").read_text()
    assert f"kMaxN = {dfs.MAX_N};" in source
    assert f"kMaxMembers = {dfs.MAX_MEMBERS_PER_BLOCK};" in source
    assert "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64" in source
    assert "__syncthreads" not in source  # one warp per member: no barrier of the block
    assert "df_sweep_pallas.py:78" in source
    np.testing.assert_array_equal(dfs.MAGNUS_NODES[3], JAX_NODES[3])
    np.testing.assert_array_equal(dfs.MAGNUS_NODES[2], JAX_NODES[2])


@pytest.mark.parametrize(
    "members, per_block, blocks",
    [(2048, 1, 2048),  # a launch of the df32 row: one member per block, one wave
     (17, 1, 17),  # the Chebyshev row's launch: one SM per member
     (1, 1, 1)],
)
def test_launch_shape(members, per_block, blocks):
    """Kernel B8's launch shape, by the wrapper's shared-memory reckoning: at
    the df32 row (n = 16, k = 2, Magnus-3) a member takes 12,848 bytes, so more
    than 8 members (16) are resident per SM and a chunk of 2,048 fits the 132
    SMs at once; a small launch spreads over as many blocks as it has members."""
    shape = dfs.launch_shape(16, 2, 3, True, members)
    assert dfs.member_smem_bytes(16, 2, 3) == 12848
    assert shape.members_per_sm > 8
    assert dfs.SMS * shape.members_per_sm >= 2048
    assert (shape.members_per_block, shape.blocks) == (per_block, blocks)
    assert shape.smem_bytes == per_block * 12848


def test_launch_shape_and_layout_by_size():
    """Padding to the FP64 tensor cores' multiple of 8; more members per block
    at small n and large launches, fewer once that would leave SMs idle;
    Magnus-3 above n = 16 holds two more planes; the table layout by size."""
    assert [dfs.padded(n) for n in (1, 8, 9, 16, 17, 27, 32)] == [8, 8, 16, 16, 24, 32, 32]
    big, small = dfs.launch_shape(4, 2, 3, False, 5000), dfs.launch_shape(4, 2, 3, False, 200)
    assert big.members_per_block > 1 and big.blocks >= dfs.SMS
    assert small.members_per_block == 1 and small.blocks == 200
    assert dfs.member_smem_bytes(27, 0, 3) - dfs.member_smem_bytes(27, 0, 2) == 2 * 16 * 32**2
    assert dfs.rotated_tables(16, 2, 3, 500)  # the df32 row: 18.4 MB of rotated tables
    assert not dfs.rotated_tables(32, 2, 3, 300)  # 44 MB: the (cos, sin) table
