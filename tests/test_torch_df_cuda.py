"""The native-FP64 kernels against their plain versions, on the card.

Kernel B8 (``csrc/df_magnus_sweep.cu``, the Magnus-2/3 sweep in complex128)
and the complex128 instantiations of B5 (``csrc/chain_apply.cu``) and B6
(``csrc/batched_linalg.cu``'s Taylor expm). These tests need an NVIDIA GPU
with nvcc; without one they skip. On the card run them with
``python -m pytest tests/test_torch_df_cuda.py -m cuda --noconftest``. This
file imports nothing of JAX.

Bars: B8 and B6 fuse multiply-adds and sum in their own order, so they agree
with their plain versions (eager complex128 PyTorch) to float64 roundoff:
within 1e-12 on unit-norm states and inputs. The chain kernel is built
without multiply-add contraction and repeats its plain version's rounded
operations in order: bit for bit, in complex128 as in complex64.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.ops import batched_linalg as bl
from qiskit_dynamics_tpu_torch.ops import chain_apply as ca
from qiskit_dynamics_tpu_torch.ops import df_sweep as dfs

pytestmark = pytest.mark.cuda

TOL = 1e-12
DF_DIMS = (2, 4, 9, 16, 27, 32)
PT_DIMS = (2, 4, 10, 16, 32)
MEMBERS = 37  # not a multiple of any block's member count
STEPS = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def df_problem(n, magnus_order, uniform, device, seed=0):
    """Seeded anti-Hermitian frame-basis operators (k = 2), an antisymmetric
    frame matrix, coefficients at the Gauss nodes, unit-norm states, and a
    uniform or non-uniform grid of STEPS steps."""
    gen = np.random.default_rng(1000 * n + 10 * magnus_order + seed)

    def anti_hermitian(scale):
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return -1j * scale * (a + a.conj().T) / (2 * np.sqrt(n))

    w = gen.uniform(0.0, 30.0, n)
    y0 = gen.normal(size=(n, MEMBERS)) + 1j * gen.normal(size=(n, MEMBERS))
    nodes = len(dfs.MAGNUS_NODES[magnus_order])
    dt = 0.05 if uniform else 0.05 * (1.0 + 0.5 * np.sin(np.arange(STEPS)))
    args = (anti_hermitian(2.0), np.stack([anti_hermitian(1.0) for _ in range(2)]),
            w[None, :] - w[:, None], gen.normal(size=(STEPS, nodes, 2, MEMBERS)),
            torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=device))
    return args, dict(dt=dt, t0=3.0, magnus_order=magnus_order)


@pytest.mark.parametrize("uniform, slots", [(True, False), (False, True)])
@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("magnus_order", [2, 3])
@pytest.mark.parametrize("n", DF_DIMS)
def test_df_sweep_kernel_matches_plain(cuda, n, magnus_order, hermitian, uniform, slots):
    args, kwargs = df_problem(n, magnus_order, uniform, cuda)
    kwargs.update(hermitian=hermitian, chunk_b=16)  # three launches, the last ragged
    if slots:
        kwargs["eval_slots"] = tuple(s // 4 if s % 4 == 3 else -1 for s in range(STEPS))
    before = dfs.sweep_expm_magnus_df.launches
    out = dfs.sweep_expm_magnus_df(*args, **kwargs)
    torch.cuda.synchronize()
    assert dfs.sweep_expm_magnus_df.launches == before + 3
    inputs = dfs.prepare_df_inputs(*args, **{k: v for k, v in kwargs.items() if k != "chunk_b"})
    plain, plain_traj = dfs.sweep_expm_magnus_df_plain(inputs)
    got = out if not slots else out[0]
    assert got.dtype == torch.complex128 and got.shape == (n, MEMBERS)
    assert float((got - plain).abs().max()) <= TOL
    if slots:
        assert out[1].shape == (3, n, MEMBERS)
        assert float((out[1] - plain_traj).abs().max()) <= TOL
        assert torch.equal(out[1][-1], out[0])  # the last slot is the last step


def test_df_sweep_kernel_rejects(cuda):
    args, kwargs = df_problem(dfs.MAX_N + 1, 3, True, cuda)
    with pytest.raises(ValueError, match="n <= 32"):
        dfs.sweep_expm_magnus_df(*args, **kwargs)


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
    before = ca.chain_apply_bol.launches
    out = ca.chain_apply_bol(props, y0)
    torch.cuda.synchronize()
    assert ca.chain_apply_bol.launches == before + 1
    assert out.dtype == torch.complex128
    assert torch.equal(out, ca.chain_apply_bol_plain(props, y0))


@pytest.mark.parametrize("order, squarings", [(8, 0), (12, 1), (12, 2)])
@pytest.mark.parametrize("n", PT_DIMS)
def test_expm_kernel_complex128_matches_plain(cuda, n, order, squarings):
    gen = np.random.default_rng(n)
    x = gen.normal(size=(2, n, n, 1000))
    x = x / np.sqrt((x**2).sum(axis=(0, 1, 2), keepdims=True))
    planes = [torch.as_tensor(p, device=cuda) for p in x]
    before = bl.expm_taylor_bol.launches
    pr, pi = bl.expm_taylor_bol(*planes, order, squarings)
    torch.cuda.synchronize()
    assert bl.expm_taylor_bol.launches == before + 1
    assert pr.dtype == torch.float64
    want = bl.expm_taylor_bol_plain(*planes, order, squarings)
    assert max(float((g - w).abs().max()) for g, w in zip((pr, pi), want)) <= TOL
