"""The CUDA lockstep-adaptive dopri5 kernel against its eager twin, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``.
The kernel is built without FMA contraction and the twin performs its
operations in the kernel's order, so the two are expected to agree to the
last bit; the bars are the port's acceptance criteria (states within 1e-5,
equal accepted-step records). This file imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.ops import adaptive_sweep as asw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(n: int, members: int, cuda):
    gen = np.random.default_rng(n)
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    a = gen.normal(size=(3, n, n)) + 1j * gen.normal(size=(3, n, n))
    herm = (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
    static = -1j * herm[0]
    np.fill_diagonal(static, 0.0)
    ops = -1j * herm[1:] * 2 * np.pi * 0.2
    amp = gen.uniform(0.5, 2.0, members) * np.exp(1j * gen.uniform(0, 2 * np.pi, members))
    amps = torch.as_tensor(np.stack([amp, amp * np.exp(-1j * np.pi / 2)]), device=cuda)
    y0 = torch.zeros((n, members), dtype=torch.complex128, device=cuda)
    y0[0] = 1.0
    return static, ops, w[None, :] - w[:, None], np.full(2, 2 * np.pi * 0.4), amps, y0


@pytest.mark.parametrize("n", [4, 9, 16, 27])
@pytest.mark.parametrize("table", [False, True])
def test_kernel_matches_twin(cuda, n, table):
    static, ops, omega, freqs, amps, y0 = _problem(n, 512, cuda)
    kwargs = dict(tf=2.0, atol=1e-3, rtol=1e-3, h0=0.1, tile_b=256, max_steps=2048)
    if table:
        amps = amps[:, None, :] * torch.linspace(0.2, 1.0, 8, device=cuda)[None, :, None]
        kwargs["env_dt"] = 0.25
    args = (static, ops, omega, freqs, amps, y0)
    before = asw.sweep_dopri5_lockstep.launches
    out, rec = asw.sweep_dopri5_lockstep(*args, record_steps=True, **kwargs)
    twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(
        asw.prepare_inputs(*args, **kwargs), record_steps=True
    )
    torch.cuda.synchronize()
    assert asw.sweep_dopri5_lockstep.launches == before + 1
    assert float((out - twin).abs().max()) <= 1e-5
    np.testing.assert_array_equal(rec.cpu().numpy(), twin_rec.cpu().numpy())


def test_kernel_rejects_large_n(cuda):
    n = asw.MAX_N + 1
    static, ops, omega, freqs, amps, y0 = _problem(n, 4, cuda)
    with pytest.raises(ValueError, match="n <= 64"):
        asw.sweep_dopri5_lockstep(static, ops, omega, freqs, amps, y0, tf=1.0, tile_b=4)
