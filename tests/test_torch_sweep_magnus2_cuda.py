"""The CUDA fixed-step Magnus-2 kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_sweep_magnus2_cuda.py -m cuda``.
The kernel is built without FMA contraction and the plain version performs
its float operations in the kernel's order, so the two are expected to agree
to the last bit; the bar is the port's acceptance criterion (states within
1e-5 on norm-1 states). This file imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(n: int, members: int, steps: int, cuda):
    gen = np.random.default_rng(n)
    a = gen.normal(size=(3, n, n)) + 1j * gen.normal(size=(3, n, n))
    herm = (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, 2, 2, members)), device=cuda).float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    return -1j * herm[0], -1j * herm[1:], w[None, :] - w[:, None], coef, y0


@pytest.mark.parametrize("n", [4, 9, 16, 25])
@pytest.mark.parametrize("mode", ["matrix", "matrix_herm", "matvec"])
def test_kernel_matches_plain(cuda, n, mode):
    args = _problem(n, 200, 12, cuda)  # 200 lanes: a ragged last block
    kwargs = dict(dt=0.05, t0=0.2, tile_b=8, hermitian=True, mode=mode)
    before = ssw.sweep_expm_magnus2.launches
    out = ssw.sweep_expm_magnus2(*args, **kwargs)
    plain, _ = ssw.sweep_expm_magnus2_plain(ssw.prepare_inputs(*args, **kwargs))
    torch.cuda.synchronize()
    assert ssw.sweep_expm_magnus2.launches == before + 1
    assert float((out - plain).abs().max()) <= 1e-5


def test_kernel_trajectory_matches_plain(cuda):
    args = _problem(16, 96, 12, cuda)
    slots = (-1, 0, -1, -1, 1, -1, -1, -1, -1, -1, -1, 2)
    kwargs = dict(dt=0.05, tile_b=8, hermitian=True, eval_slots=slots)
    out, traj = ssw.sweep_expm_magnus2(*args, **kwargs)
    plain, plain_traj = ssw.sweep_expm_magnus2_plain(ssw.prepare_inputs(*args, **kwargs))
    torch.cuda.synchronize()
    assert traj.shape == (3, 16, 96)
    assert float((traj - plain_traj).abs().max()) <= 1e-5
    assert torch.equal(traj[-1], out)  # the last slot is the last step


def test_kernel_rejects_float64_and_large_n(cuda):
    static, ops, omega, coef, y0 = _problem(4, 8, 2, cuda)
    with pytest.raises(TypeError, match="kernel B8"):
        ssw.sweep_expm_magnus2(static, ops, omega, coef.double(), y0, dt=0.1, tile_b=8)
    static, ops, omega, coef, y0 = _problem(ssw.MAX_N + 1, 8, 2, cuda)
    with pytest.raises(ValueError, match="n <= 32"):
        ssw.sweep_expm_magnus2(static, ops, omega, coef, y0, dt=0.1, tile_b=8)
