"""The CUDA fixed-step Magnus-2 kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_sweep_magnus2_cuda.py -m cuda``.
The kernel fuses multiply-adds and splits its sums, and the plain version
performs its float operations one at a time, so the two agree to float32
roundoff, not bit for bit; the bar is the port's acceptance criterion
(states within 1e-5 on norm-1 states). The edge cases also hold the plain
version against the complex128 eager engine (``ops/xla_sweep.py``), the same
polynomial in float64. This file imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import sweep_solver as ssw
from qiskit_dynamics_tpu_torch.ops.xla_sweep import sweep_expm_magnus2_xla

pytestmark = pytest.mark.cuda

B2_TOL = 1e-5  # kernel vs plain version, float32 both, norm-1 states
# plain version (float32) vs the complex128 eager engine, the same polynomial
# over 12 steps: float32 roundoff (1.8e-7 on the CPU)
ENGINE_TOL = 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _problem(n: int, members: int, steps: int, cuda, k: int = 2):
    gen = np.random.default_rng(n + 100 * k)
    a = gen.normal(size=(k + 1, n, n)) + 1j * gen.normal(size=(k + 1, n, n))
    herm = (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, 2, k, members)), device=cuda).float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    return -1j * herm[0], -1j * herm[1:], w[None, :] - w[:, None], coef, y0


@pytest.mark.parametrize("n", [4, 9, 16, 25])
@pytest.mark.parametrize("mode", ["matrix", "matrix_herm", "matvec"])
def test_kernel_matches_plain(cuda, n, mode):
    args = _problem(n, 200, 12, cuda)  # 200 lanes: a ragged last block
    kwargs = dict(dt=0.05, t0=0.2, tile_b=8, hermitian=True, mode=mode)
    before = launches("sweep_magnus2_launch")
    out = ssw.sweep_expm_magnus2(*args, **kwargs)
    plain, _ = ssw.sweep_expm_magnus2_plain(ssw.prepare_inputs(*args, **kwargs))
    torch.cuda.synchronize()
    assert launches("sweep_magnus2_launch") == before + 1
    assert float((out - plain).abs().max()) <= 1e-5


# the lane-group edges: groups with lanes that hold padded rows or nothing
# (n = 1, 3, 5, 17, 31), full groups (8, 32); 37 members leave the last
# block ragged at every group size
EDGE_DIMS = (1, 3, 5, 8, 17, 31, 32)


@pytest.mark.parametrize("n", EDGE_DIMS)
@pytest.mark.parametrize("mode", ["matrix", "matrix_herm", "matvec"])
@pytest.mark.parametrize("k", [0, 3])
def test_kernel_edges_match_plain_and_engine(cuda, n, mode, k):
    steps, members = 12, 37
    static, ops, omega, coef, y0 = _problem(n, members, steps, cuda, k=k)
    slots = (-1, 0, -1, -1, 1, -1, -1, -1, -1, -1, -1, 2)
    kwargs = dict(dt=0.05, t0=0.2, tile_b=1, hermitian=True, mode=mode, eval_slots=slots)
    args = (static, ops, omega, coef, y0)
    before = launches("sweep_magnus2_launch")
    out, traj = ssw.sweep_expm_magnus2(*args, **kwargs)
    torch.cuda.synchronize()
    assert launches("sweep_magnus2_launch") == before + 1
    plain, plain_traj = ssw.sweep_expm_magnus2_plain(ssw.prepare_inputs(*args, **kwargs))
    assert out.shape == (n, members) and traj.shape == (3, n, members)
    assert float((out - plain).abs().max()) <= B2_TOL
    assert float((traj - plain_traj).abs().max()) <= B2_TOL
    assert torch.equal(traj[-1], out)  # the last slot is the last step
    engine, engine_traj = sweep_expm_magnus2_xla(
        static, ops, omega, coef.double(), y0, dt=0.05, t0=0.2, hermitian=True,
        eval_slots=slots,
    )
    assert float((plain - engine).abs().max()) <= ENGINE_TOL
    assert float((plain_traj - engine_traj).abs().max()) <= ENGINE_TOL


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


@pytest.mark.parametrize("n", [1, 4, 9, 16, 25, 32])
def test_launch_shape(cuda, n):
    """A member's lanes are the power of two >= n (at least 4), so a warp
    holds whole members; the grid covers the sweep; the block fits and at
    least one stays resident; the default block size has the least wave
    cost."""
    shape = ssw.launch_shape(n, 2, "matrix_herm", 10_000)
    assert shape.columns == ssw.columns(n)
    assert shape.lanes_per_member == max(4, 1 << (n - 1).bit_length())  # a power of two >= n
    assert shape.members_per_warp == 32 // shape.lanes_per_member
    per_block = shape.members_per_warp * shape.warps_per_block
    assert shape.blocks == -(-10_000 // per_block)
    assert shape.smem_bytes <= ssw.MAX_SHARED_BYTES and shape.blocks_per_sm >= 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    others = [ssw.launch_shape(n, 2, "matrix_herm", 10_000, warps=w)
              for w in range(1, ssw.MAX_WARPS_PER_BLOCK + 1)
              if ssw._LIB.sweep_magnus2_smem_bytes(n, 2, 1, w) <= ssw.MAX_SHARED_BYTES]
    assert ssw.wave_cost(shape, sms) == min(ssw.wave_cost(o, sms) for o in others)


def test_kernel_block_sizes_agree(cuda):
    """Every block size gives the same states: warps run independently."""
    args = _problem(16, 37, 6, cuda)
    inputs = ssw.prepare_inputs(*args, dt=0.05, tile_b=1, hermitian=True, mode="matrix_herm")
    outs = [ssw._launch_kernel(inputs, warps=w)[0] for w in range(1, ssw.MAX_WARPS_PER_BLOCK + 1)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_kernel_rejects_float64_and_large_n(cuda):
    static, ops, omega, coef, y0 = _problem(4, 8, 2, cuda)
    with pytest.raises(TypeError, match="kernel B8"):
        ssw.sweep_expm_magnus2(static, ops, omega, coef.double(), y0, dt=0.1, tile_b=8)
    static, ops, omega, coef, y0 = _problem(ssw.MAX_N + 1, 8, 2, cuda)
    with pytest.raises(ValueError, match="n <= 32"):
        ssw.sweep_expm_magnus2(static, ops, omega, coef, y0, dt=0.1, tile_b=8)
