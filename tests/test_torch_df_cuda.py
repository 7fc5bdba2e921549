"""The native-FP64 kernels against their plain versions, on the card.

Kernel B8 (``csrc/df_magnus_sweep.cu``, the Magnus-2/3 sweep in complex128,
its tensor-core sweep up to n = 32 and its one-block-per-member sweep above)
and the complex128 instantiations of B5 (``csrc/chain_apply.cu``) and B6
(``csrc/batched_linalg.cu``'s Taylor expm). These tests need an NVIDIA GPU
with nvcc; without one they skip. On the card run them with
``python -m pytest tests/test_torch_df_cuda.py -m cuda --noconftest``. This
file imports nothing of JAX.

Bars: B8 and B6 fuse multiply-adds and sum in their own order, so they agree
with their plain versions (eager complex128 PyTorch) to float64 roundoff:
within 1e-12 on unit-norm states and inputs. B8's products run on the FP64
tensor cores (DMMA, IEEE FP64 fused multiply-adds): one such product, a
commutator and C - C^H through the kernel's fragments and transposed reads
are held against ``torch.matmul`` in complex128 within 1e-12 on unit-scale
entries. The chain kernel is built
without multiply-add contraction and repeats its plain version's rounded
operations in order: bit for bit, in complex128 as in complex64.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
from qiskit_dynamics_tpu_torch.ops import chain_apply as ca
from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs

B8 = ("df_magnus_sweep_launch", "df_magnus_wide_launch")  # kernel B8's two sweeps

pytestmark = pytest.mark.cuda

TOL = 1e-12
# chip_smoke.DF_DIMS and three more off the kernel's multiples of 8
DF_DIMS = (2, 4, 5, 9, 13, 16, 27, 31, 32)
PT_DIMS = (2, 4, 10, 16, 32)
MEMBERS = 37  # not a multiple of any block's member count
STEPS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def df_problem(n, magnus_order, uniform, device, seed=0, members=MEMBERS, steps=STEPS, t0=3.0):
    """Seeded anti-Hermitian frame-basis operators (k = 2), an antisymmetric
    frame matrix (|omega| < 30), coefficients at the Gauss nodes, unit-norm
    states, and a uniform or non-uniform grid of ``steps`` steps from t0."""
    gen = np.random.default_rng(1000 * n + 10 * magnus_order + seed)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    w = gen.uniform(0.0, 30.0, n)
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    nodes = len(dfs.MAGNUS_NODES[magnus_order])
    dt = 0.05 if uniform else 0.05 * (1.0 + 0.5 * np.sin(np.arange(steps)))
    args = (anti_hermitian(2.0), np.stack([anti_hermitian(1.0) for _ in range(2)]),
            w[None, :] - w[:, None], gen.normal(size=(steps, nodes, 2, members)),
            torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=device))
    return args, dict(dt=dt, t0=t0, magnus_order=magnus_order)


def assert_matches_plain(args, kwargs, **launch):
    """B8 through the wrapper (keywords ``launch`` passed on) against the plain
    version on the same inputs, within TOL; returns the kernel's result."""
    out = dfs.sweep_expm_magnus_df(*args, **kwargs, **launch)
    torch.cuda.synchronize()
    plain, _ = dfs.sweep_expm_magnus_df_plain(dfs.prepare_df_inputs(*args, **kwargs))
    assert out.dtype == torch.complex128 and out.shape == plain.shape
    assert float((out - plain).abs().max()) <= TOL
    return out


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n", [8, 9, 16, 27])
def test_dmma_product_matches_matmul(cuda, n, mode):
    """The kernel's FP64 tensor-core product (mma.sync m8n8k4 fragments, the
    swizzled planes, zero padding to a multiple of 8): X Y, X Y - Y X, and
    C - C^H by the transposed reads, against torch.matmul in complex128."""
    gen = np.random.default_rng(10 * n + mode)
    x, y = (torch.as_tensor(gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n)), device=cuda)
            / np.sqrt(n) for _ in range(2))
    c = x @ y
    want = (c, c - y @ x, c - c.mH)[mode]
    got = dfs._dmma_product(x, y, mode)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


def test_launch_shape_matches_library(cuda):
    """The wrapper's shared-memory reckoning is the library's, and at the df32
    row's shape the card holds more than 8 members per SM."""
    lib = dfs._LIB
    for n in (2, 8, 9, 16, 17, 24, 27, 32):
        for k in (0, 1, 2, 5):
            for nn in (2, 3):
                for mb in (1, 2, 4, 8):
                    assert lib.df_magnus_sweep_smem_bytes(n, k, nn, 1, mb) == (
                        mb * dfs.member_smem_bytes(n, k, nn))
    shape = dfs.launch_shape(16, 2, 3, True, 2048)
    blocks = lib.df_magnus_sweep_active_blocks(16, 2, 3, 1, shape.members_per_block)
    assert blocks * shape.members_per_block >= 8


@pytest.mark.parametrize("uniform, slots", [(True, False), (False, True)])
@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("magnus_order", [2, 3])
@pytest.mark.parametrize("n", DF_DIMS)
def test_df_sweep_kernel_matches_plain(cuda, n, magnus_order, hermitian, uniform, slots):
    args, kwargs = df_problem(n, magnus_order, uniform, cuda)
    kwargs.update(hermitian=hermitian, chunk_b=16)  # three launches, the last ragged
    if slots:
        kwargs["eval_slots"] = tuple(s // 4 if s % 4 == 3 else -1 for s in range(STEPS))
    before = launches(*B8)
    out = dfs.sweep_expm_magnus_df(*args, **kwargs)
    torch.cuda.synchronize()
    assert launches(*B8) == before + 3
    inputs = dfs.prepare_df_inputs(*args, **{k: v for k, v in kwargs.items() if k != "chunk_b"})
    plain, plain_traj = dfs.sweep_expm_magnus_df_plain(inputs)
    got = out if not slots else out[0]
    assert got.dtype == torch.complex128 and got.shape == (n, MEMBERS)
    assert float((got - plain).abs().max()) <= TOL
    if slots:
        assert out[1].shape == (3, n, MEMBERS)
        assert float((out[1] - plain_traj).abs().max()) <= TOL
        assert torch.equal(out[1][-1], out[0])  # the last slot is the last step


@pytest.mark.parametrize("members", [1, 17, 2049])
def test_df_sweep_member_counts(cuda, members):
    """One member; a launch of 17 (one member per block, 17 blocks); one past a
    full chunk of 2,048 (two launches, the second of one member)."""
    args, kwargs = df_problem(16, 3, True, cuda, members=members, steps=6)
    kwargs["hermitian"] = True
    before = launches(*B8)
    assert_matches_plain(args, kwargs)
    assert launches(*B8) == before + -(-members // 2048)


@pytest.mark.parametrize("hermitian", [False, True])
def test_df_sweep_large_phase_arguments(cuda, hermitian):
    """Node times near 330 and |omega| up to 30: phase arguments reach ~1e4
    rad, so the table's fmod reduction carries the phases."""
    args, kwargs = df_problem(13, 3, False, cuda, steps=8, t0=330.0)
    kwargs["hermitian"] = hermitian
    assert float(np.abs(args[2]).max()) * 330.0 > 5e3
    assert_matches_plain(args, kwargs, chunk_b=16)


@pytest.mark.parametrize("rotated", [None, False, True])
def test_df_sweep_table_layouts(cuda, rotated):
    """Both table layouts: at n = 32 and 300 Magnus-3 steps the rotated
    tables would take 44 MB, so the call takes the (cos, sin) table; forced
    either way at a small shape."""
    if rotated is None:
        args, kwargs = df_problem(32, 3, True, cuda, members=5, steps=300)
        inputs = dfs.prepare_df_inputs(*args, **kwargs)
        assert not dfs.rotated_tables(inputs.n, inputs.k, 3, inputs.steps)
        out, _ = dfs._launch_kernel(inputs, 2048)
    else:
        args, kwargs = df_problem(9, 3, False, cuda, members=5)
        inputs = dfs.prepare_df_inputs(*args, **kwargs)
        out, _ = dfs._launch_kernel(inputs, 2, rotated=rotated)
    torch.cuda.synchronize()
    plain, _ = dfs.sweep_expm_magnus_df_plain(inputs)
    assert float((out - plain).abs().max()) <= TOL


def test_df_sweep_kernel_rejects(cuda):
    args, kwargs = df_problem(dfs.MAX_WIDE_N + 1, 3, True, cuda, members=2, steps=1)
    with pytest.raises(ValueError, match=f"n <= {dfs.MAX_WIDE_N}"):
        dfs.sweep_expm_magnus_df(*args, **kwargs)


# past 32: 33, 36 (a dim-6 vectorized Lindblad model), 45 (the last whose
# planes fit shared memory) and 46, 64 (planes in device memory)
WIDE_DF_DIMS = (33, 36, 45, 46, 64)


@pytest.mark.parametrize("uniform, slots", [(True, False), (False, True)])
@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("magnus_order", [2, 3])
@pytest.mark.parametrize("n", WIDE_DF_DIMS)
def test_df_sweep_wide_kernel_matches_plain(cuda, n, magnus_order, hermitian, uniform, slots):
    """Above n = 32 the one-block-per-member sweep: the plain version's
    result within float64 roundoff, one launch per chunk."""
    assert dfs.kernel_for(n) == "wide"
    args, kwargs = df_problem(n, magnus_order, uniform, cuda, steps=6)
    kwargs.update(hermitian=hermitian, chunk_b=16)  # three launches, the last ragged
    if slots:
        kwargs["eval_slots"] = tuple(s // 2 if s % 2 == 1 else -1 for s in range(6))
    before = launches(*B8)
    out = dfs.sweep_expm_magnus_df(*args, **kwargs)
    torch.cuda.synchronize()
    assert launches(*B8) == before + 3
    inputs = dfs.prepare_df_inputs(*args, **{k: v for k, v in kwargs.items() if k != "chunk_b"})
    plain, plain_traj = dfs.sweep_expm_magnus_df_plain(inputs)
    got = out if not slots else out[0]
    assert got.dtype == torch.complex128 and got.shape == (n, MEMBERS)
    assert float((got - plain).abs().max()) <= TOL
    if slots:
        assert out[1].shape == (3, n, MEMBERS)
        assert float((out[1] - plain_traj).abs().max()) <= TOL
        assert torch.equal(out[1][-1], out[0])


def test_df32_lindblad_sweep_past_32(cuda):
    """``fused_sweep_solve(precision="df32")`` of a vectorized dim-6 Lindblad
    model (solve_dim 36) on the card: the CPU's result within float64
    roundoff, through B8's wide sweep."""
    from qiskit_dynamics_tpu_torch import Signal
    from qiskit_dynamics_tpu_torch.benchmarks import lindblad_qudit_solver
    from qiskit_dynamics_tpu_torch.solvers.fused_sweep import fused_sweep_solve

    def run(device):
        solver, rho0, carrier = lindblad_qudit_solver(dim=6, device=device)

        def signals_fn(amp):
            return [Signal(amp, carrier_freq=carrier)]

        amps = torch.linspace(0.2, 1.0, 9, dtype=torch.float64, device=device)
        return fused_sweep_solve(solver.model, signals_fn, amps, (0.0, 2.0), 0.1, rho0,
                                 precision="df32")

    before = launches(*B8)
    got = run(cuda)
    torch.cuda.synchronize()
    assert launches(*B8) == before + 1
    want = run("cpu")
    assert got.device.type == "cuda" and got.shape == want.shape == (9, 6, 6)
    assert float((got.cpu() - want).abs().max()) <= TOL


def unitary_stack(gen, T, n, B):
    """(T, n, n, B) complex128 near-unitary propagators: exp(-i H) to second
    order for small Hermitian H."""
    h = gen.normal(size=(T, B, n, n)) + 1j * gen.normal(size=(T, B, n, n))
    h = 0.3 / np.sqrt(n) * (h + np.conj(np.swapaxes(h, -1, -2))) / 2
    u = np.eye(n) - 1j * h - h @ h / 2
    return np.ascontiguousarray(np.transpose(u, (0, 2, 3, 1)))


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("B", [37, 1000])
@pytest.mark.parametrize("n", PT_DIMS)
def test_chain_kernel_complex128_bitwise(cuda, n, B, T):
    gen = np.random.default_rng(100 * n + T)
    props = torch.as_tensor(unitary_stack(gen, T, n, B), device=cuda)
    y0 = gen.normal(size=(n, B)) + 1j * gen.normal(size=(n, B))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    before = launches("chain_apply_launch")
    out = ca.chain_apply_bol(props, y0)
    torch.cuda.synchronize()
    assert launches("chain_apply_launch") == before + 1
    assert out.dtype == torch.complex128
    assert torch.equal(out, ca.chain_apply_bol_plain(props, y0))


@pytest.mark.parametrize("order, squarings", [(8, 0), (12, 1), (12, 2)])
@pytest.mark.parametrize("n", PT_DIMS)
def test_expm_kernel_complex128_matches_plain(cuda, n, order, squarings):
    gen = np.random.default_rng(n)
    x = gen.normal(size=(2, n, n, 1000))
    x = x / np.sqrt((x**2).sum(axis=(0, 1, 2), keepdims=True))
    planes = [torch.as_tensor(p, device=cuda) for p in x]
    before = launches("expm_bol_launch")
    pr, pi = bl.expm_taylor_bol(*planes, order, squarings)
    torch.cuda.synchronize()
    assert launches("expm_bol_launch") == before + 1
    assert pr.dtype == torch.float64
    want = bl.expm_taylor_bol_plain(*planes, order, squarings)
    assert max(float((g - w).abs().max()) for g, w in zip((pr, pi), want)) <= TOL
