"""The CUDA lockstep-adaptive dopri5 kernel against its eager twin, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_kernel_cuda.py -m cuda``.
The kernel is built without FMA contraction and the twin performs its
operations in the kernel's order, so the two are expected to agree to the
last bit; the bars are the port's acceptance criteria (states within 1e-5,
equal accepted-step records). The launch-shape tests hold the kernel at every
shape it can take, forced through ``_launch_kernel(shape=...)``, to the
twin's states bit for bit and to its step records. This file imports nothing
of JAX.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
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


@pytest.mark.parametrize("n", [1, 4, 9, 16, 27, 33, 64])
@pytest.mark.parametrize("table", [False, True])
def test_kernel_matches_twin(cuda, n, table):
    static, ops, omega, freqs, amps, y0 = _problem(n, 512, cuda)
    kwargs = dict(tf=2.0, atol=1e-3, rtol=1e-3, h0=0.1, tile_b=256, max_steps=2048)
    if table:
        amps = amps[:, None, :] * torch.linspace(0.2, 1.0, 8, device=cuda)[None, :, None]
        kwargs["env_dt"] = 0.25
    args = (static, ops, omega, freqs, amps, y0)
    before = launches("adaptive_sweep_launch")
    out, rec = asw.sweep_dopri5_lockstep(*args, record_steps=True, **kwargs)
    twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(
        asw.prepare_inputs(*args, **kwargs), record_steps=True
    )
    torch.cuda.synchronize()
    assert launches("adaptive_sweep_launch") == before + 1
    assert float((out - twin).abs().max()) <= 1e-5
    np.testing.assert_array_equal(rec.cpu().numpy(), twin_rec.cpu().numpy())


def _forced(cuda, n, members, tile_b, shape, table=False, eval_ts=None, **extra):
    """The kernel at ``shape`` against the twin: equal states (NaN where the
    twin has NaN), equal trajectories and step records, one launch."""
    static, ops, omega, freqs, amps, y0 = _problem(n, members, cuda)
    kwargs = {**dict(tf=2.0, atol=1e-3, rtol=1e-3, h0=0.1, tile_b=tile_b, max_steps=2048), **extra}
    if table:
        amps = amps[:, None, :] * torch.linspace(0.2, 1.0, 8, device=cuda)[None, :, None]
        kwargs["env_dt"] = 0.25
    if eval_ts is not None:
        kwargs["eval_ts"] = eval_ts
    inputs = asw.prepare_inputs(static, ops, omega, freqs, amps, y0, **kwargs)
    before = launches("adaptive_sweep_launch")
    out, traj, rec = asw._launch_kernel(inputs, True, shape=shape)
    twin, twin_traj, twin_rec = asw.sweep_dopri5_lockstep_plain(inputs, record_steps=True)
    torch.cuda.synchronize()
    assert launches("adaptive_sweep_launch") == before + 1
    torch.testing.assert_close(out, twin, rtol=0, atol=0, equal_nan=True)
    if eval_ts is not None:
        torch.testing.assert_close(traj, twin_traj, rtol=0, atol=0, equal_nan=True)
    np.testing.assert_array_equal(rec.cpu().numpy(), twin_rec.cpu().numpy())


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [4, 16, 33])
def test_kernel_cluster_sizes_match_twin(cuda, n, cluster):
    """Clusters of 1 to 16 blocks at tile_b = 512 (fewer blocks run several
    members per lane group from the scratch buffer), envelope tables and eval
    times."""
    shape = asw.shape_for(n, 2, 512, cluster)
    _forced(cuda, n, 1024, 512, shape, table=True, eval_ts=(0.55, 1.3, 2.0))


def test_kernel_candidate_shapes_match_twin(cuda):
    """Every shape that keeps a member in registers at the main row's n and
    tile_b, the one ``launch_shape`` picks among them."""
    shapes = asw.candidate_shapes(16, 2, 512)
    assert asw.launch_shape(16, 2, 512) in shapes
    for shape in shapes:
        _forced(cuda, 16, 1024, 512, shape)


@pytest.mark.parametrize("n, tile_b", [(4, 12), (16, 12), (16, 20), (27, 36), (64, 12)])
def test_kernel_ragged_tiles_match_twin(cuda, n, tile_b):
    """tile_b that 8 does not divide, at the shape ``launch_shape`` picks."""
    shape = asw.launch_shape(n, 2, tile_b)
    assert tile_b % shape.cluster == 0
    _forced(cuda, n, 3 * tile_b, tile_b, shape, table=True)


def test_kernel_members_per_group_match_twin(cuda):
    """A tile of 4,096 members: clusters of 16, four members per lane group
    from the scratch buffer; and one operator (any-k instantiation)."""
    shape = asw.launch_shape(16, 2, 4096)
    assert shape.members_per_group > 1
    _forced(cuda, 16, 4096, 4096, shape)
    static, ops, omega, freqs, amps, y0 = _problem(9, 256, cuda)
    kwargs = dict(tf=2.0, atol=1e-3, rtol=1e-3, h0=0.1, tile_b=256, max_steps=2048)
    args = (static, ops[:1], omega, freqs[:1], amps[:1], y0)
    out, rec = asw.sweep_dopri5_lockstep(*args, record_steps=True, **kwargs)
    twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(
        asw.prepare_inputs(*args, **kwargs), record_steps=True
    )
    torch.testing.assert_close(out, twin, rtol=0, atol=0)
    np.testing.assert_array_equal(rec.cpu().numpy(), twin_rec.cpu().numpy())


@pytest.mark.parametrize("mode", ["budget", "stall"])
def test_kernel_poisons_the_twins_tiles(cuda, mode):
    """An exhausted step budget and forced out-of-tolerance steps poison the
    same tiles as the twin, at the main row's shape (clusters of 16)."""
    extra = {"max_steps": 6} if mode == "budget" else {"atol": 1e-13, "rtol": 1e-13,
                                                          "max_steps": 24}
    _forced(cuda, 16, 1024, 512, asw.launch_shape(16, 2, 512), table=True, **extra)


@pytest.mark.parametrize("n", [9, 16])
def test_kernel_large_phase_arguments(cuda, n):
    """Phase arguments up to ~2e5 rad (t0 = 5,000): the kernel's exact phase
    reduction and sincos give the twin's fmod, cos and sin bit for bit."""
    static, ops, omega, freqs, amps, y0 = _problem(n, 512, cuda)
    inputs = asw.prepare_inputs(static, ops, omega, freqs, amps, y0, t0=5000.0, tf=5002.0,
                                atol=1e-3, rtol=1e-3, h0=0.1, tile_b=256, max_steps=2048)
    out, _, rec = asw._launch_kernel(inputs, True)
    twin, _, twin_rec = asw.sweep_dopri5_lockstep_plain(inputs, record_steps=True)
    torch.testing.assert_close(out, twin, rtol=0, atol=0)
    np.testing.assert_array_equal(rec.cpu().numpy(), twin_rec.cpu().numpy())


def test_shared_bytes_match_library(cuda):
    """The wrapper's shared-memory reckoning is the library's."""
    lib = asw._LIB
    for n, k, stages, threads, lanes in [(16, 2, 6, 512, 8), (33, 2, 3, 1024, 32),
                                         (9, 1, 6, 512, 16), (64, 3, 1, 512, 16)]:
        assert asw.shared_bytes(n, k, stages, threads, lanes) == lib.adaptive_sweep_smem_bytes(
            n, k, stages, threads, lanes)


def test_kernel_main_shape_is_resident(cuda):
    """The card co-schedules clusters of the main row's shape."""
    assert asw.active_clusters(16, 2, 512) >= 1


def test_kernel_rejects_large_n(cuda):
    n = asw.MAX_N + 1
    static, ops, omega, freqs, amps, y0 = _problem(n, 4, cuda)
    with pytest.raises(ValueError, match="n <= 64"):
        asw.sweep_dopri5_lockstep(static, ops, omega, freqs, amps, y0, tf=1.0, tile_b=4)
