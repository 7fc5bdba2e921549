"""The CUDA member-sweep and Horner kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc; without one they skip. On the card
run them with ``python -m pytest tests/test_torch_large_dim_cuda.py -m cuda
--noconftest``. Both kernels fuse multiply-adds and sum their products in
their own order (the member sweep's products run on the tensor cores in
3xTF32, which keeps float32 accuracy), so they agree with the plain versions
(``torch.matmul``) to float32 roundoff, not bit for bit: states stay within
1e-5 on norm-1 states (measured a few 1e-7). The Horner kernel is also
held at n = 1,100 and 2,048 (past the old cap of 1,024) and inside the
polynomial sweep at n = 1,040; at n = 256 a repeated polynomial sweep is
held to upload nothing of its expansion (a profiled call). The member-sweep
dims 33, 37 and 63 are ragged for its 16-row MMA tiles. Where the brackets
dominate the step (generators of norm ~20, steps of 0.1) the member sweep is
also held against the plain version in complex128 within 5e-6, which float32
products meet and single-pass TF32 products (~7e-5) fail. The benchmark's
cell ``qudit_member_sweep`` (solve dim 64) is held to one member-sweep launch
a call on ``sweep_engine="auto"``, with B3's span attributes. This file
imports nothing of JAX.
"""
import json

import numpy as np
import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import launches
from qiskit_dynamics_tpu_torch.ops import horner_pallas as hp
from qiskit_dynamics_tpu_torch.ops import member_sweep as msw
from qiskit_dynamics_tpu_torch.ops import polynomial_sweep as psw

pytestmark = pytest.mark.cuda

TOL = 1e-5
BRACKET_TOL = 5e-6  # chip_smoke.B3_BRACKET_TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def member_problem(n: int, members: int, steps: int, magnus: int, hermitian: bool, device,
                   k: int = 2, scale: float = 1.5):
    """Seeded inputs of norm-1 states; generators of spectral radius ~2
    ``scale`` (at 1.5 a step of 0.05 moves the state by ~0.15)."""
    gen = np.random.default_rng(1000 * magnus + n)
    a = gen.normal(size=(k + 1, n, n)) + 1j * gen.normal(size=(k + 1, n, n))
    if hermitian:
        a = -1j * (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
    a = a * (scale / np.sqrt(n))
    w = 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n))
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, magnus, k, members)), device=device).float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=device)
    return a[0], a[1:], w[None, :] - w[:, None], coef, y0


def horner_problem(n: int, members: int, device):
    gen = np.random.default_rng(n)
    scale = 0.7 / np.sqrt(n)
    planes = [torch.as_tensor(scale * gen.normal(size=(members, n, n)), device=device).float()
              for _ in range(2)]
    v = gen.normal(size=(2, members, n))
    v = v / np.sqrt((v**2).sum(axis=(0, 2), keepdims=True))
    return planes + [torch.as_tensor(x, device=device).float() for x in v]


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize(
    "magnus, n",
    [(2, 8), (2, 33), (2, 37), (2, 64), (2, 96), (2, 100), (2, 128),
     (3, 8), (3, 33), (3, 37), (3, 63), (3, 64)],
)
def test_member_kernel_matches_plain(cuda, magnus, n, hermitian):
    args = member_problem(n, 37, 5, magnus, hermitian, cuda)  # 37 members: a ragged batch
    kwargs = dict(dt=0.05, t0=0.2, hermitian=hermitian, magnus=magnus)
    before = launches("member_sweep_launch")
    out = msw.sweep_expm_magnus2_member(*args, **kwargs)
    plain = msw.sweep_expm_magnus2_member_plain(msw.prepare_inputs(*args, **kwargs))
    torch.cuda.synchronize()
    assert launches("member_sweep_launch") == before + 1
    assert out.shape == plain.shape == (n, 37)
    assert float((out - plain).abs().max()) <= TOL


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("magnus, n", [(2, 37), (2, 64), (3, 37), (3, 64)])
def test_member_kernel_bracket_dominated(cuda, magnus, n, hermitian):
    """Anti-Hermitian generators of norm ~20, steps of 0.1: the brackets'
    products carry much of each step, and the kernel stays within
    BRACKET_TOL of the plain version in complex128."""
    static, ops, omega, coef, y0 = member_problem(n, 37, 5, magnus, True, cuda, scale=10.0)
    kwargs = dict(dt=0.1, t0=0.2, hermitian=hermitian, magnus=magnus)
    out = msw.sweep_expm_magnus2_member(static, ops, omega, coef, y0, **kwargs)
    exact = msw.sweep_expm_magnus2_member_plain(
        msw.prepare_inputs(static, ops, omega, coef.double(), y0, **kwargs))
    torch.cuda.synchronize()
    assert exact.dtype == torch.complex128
    assert float((out - exact).abs().max()) <= BRACKET_TOL


def test_member_kernel_no_operators_and_many(cuda):
    """k = 0 (static generator only) and k = 3, both rules."""
    for magnus in (2, 3):
        for k in (0, 3):
            args = member_problem(16, 9, 4, magnus, False, cuda, k=k)
            out = msw.sweep_expm_magnus2_member(*args, dt=0.05, magnus=magnus)
            plain = msw.sweep_expm_magnus2_member_plain(
                msw.prepare_inputs(*args, dt=0.05, magnus=magnus))
            torch.cuda.synchronize()
            assert float((out - plain).abs().max()) <= TOL


@pytest.mark.parametrize("magnus, n", [(2, 37), (2, 64), (2, 100), (3, 37), (3, 64)])
def test_member_kernel_one_operator(cuda, magnus, n):
    """k = 1, the dim-8 rows' case (the generator build's items are then
    whole entry pairs)."""
    args = member_problem(n, 37, 5, magnus, False, cuda, k=1)
    kwargs = dict(dt=0.05, t0=0.2, magnus=magnus)
    out = msw.sweep_expm_magnus2_member(*args, **kwargs)
    plain = msw.sweep_expm_magnus2_member_plain(msw.prepare_inputs(*args, **kwargs))
    torch.cuda.synchronize()
    assert float((out - plain).abs().max()) <= TOL


def test_member_kernel_rejects(cuda):
    static, ops, omega, coef, y0 = member_problem(8, 4, 2, 2, False, cuda)
    with pytest.raises(TypeError, match="left from A8"):
        msw.sweep_expm_magnus2_member(static, ops, omega, coef.double(), y0, dt=0.1)
    with pytest.raises(ValueError, match="Gauss-point"):
        msw.sweep_expm_magnus2_member(static, ops, omega, coef, y0, dt=0.1, magnus=3)
    args = member_problem(msw.MAX_N + 1, 2, 1, 2, False, cuda)
    with pytest.raises(ValueError, match="n <= 128"):
        msw.sweep_expm_magnus2_member(*args, dt=0.1)
    args = member_problem(msw.MAX_N_MAGNUS3 + 1, 2, 1, 3, False, cuda)
    with pytest.raises(ValueError, match="n <= 64"):
        msw.sweep_expm_magnus2_member(*args, dt=0.1, magnus=3)


def test_the_qudit_cells_call_launches_b3_once(cuda):
    """The benchmark's cell ``qudit_member_sweep`` at full size (solve dim
    64, 10,240 members, 400 Magnus-3 steps), ``sweep_engine`` left at
    ``"auto"``: one B3 launch a call, B3's ``sweep.engine`` attributes and
    ``member.step_lanes``, and density matrices of unit trace."""
    import sys
    from pathlib import Path

    from qiskit_dynamics_tpu_torch.utils import metrics

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import model as model_mod
    from portbench import program, spec
    from portbench.traffic import Traffic

    cell = spec.load_cell("qudit_member_sweep")
    prog = program.Program(model_mod.build(cell.config), cell.traffic, cuda)
    amps = Traffic(cell.traffic, 2**31 + 23, cuda).amplitudes(0)
    prog.call(amps)  # builds B3
    torch.cuda.synchronize()
    metrics.disable_metrics(clear=True)
    metrics.enable_metrics()
    try:
        for _ in range(2):
            y, _ = prog.call(amps)
        torch.cuda.synchronize()
        assert launches("member_sweep_launch") == 2
        records = metrics.span_records()
        assert [r.attrs["engine"] for r in records if r.name == "sweep.call"] == 2 * ["member"]
        engines = [r.attrs for r in records if r.name == "sweep.engine"]
        assert engines == 2 * [dict(n=64, k=1, magnus=3, hermitian=False, steps=400,
                                    members=10_240)]
        assert metrics.counters()["member.step_lanes"] == 2 * 400 * 10_240
    finally:
        metrics.disable_metrics(clear=True)
    assert y.shape == (10_240, 8, 8) and bool(torch.isfinite(y).all())
    traces = torch.diagonal(y, dim1=-2, dim2=-1).sum(-1)
    assert float((traces - 1).abs().max()) < 1e-4


@pytest.mark.parametrize("order", [1, 8, 12, 20])
@pytest.mark.parametrize("n", [8, 33, 64, 96, 100, 129, 136, 200, 256, 320, 512])
def test_horner_kernel_matches_plain(cuda, n, order):
    """n <= 256 run the resident kernel (persistent clusters of 1 to 4 blocks;
    33 and 129 are unaligned, loaded by cp.async instead of tensor copies;
    136 and 200 split their columns unevenly over four blocks), 320 and 512
    the streaming one. 37 members: a batch that is not a multiple of the
    clusters the card co-schedules."""
    planes = horner_problem(n, 37, cuda)
    before = launches("horner_apply_launch")
    ur, ui = hp.horner_apply_bm(*planes, order=order)
    plain_r, plain_i = hp.horner_twin_bm(*planes, order=order)
    torch.cuda.synchronize()
    assert launches("horner_apply_launch") == before + 1
    assert ur.shape == ui.shape == (37, n)
    assert float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max())) <= TOL


@pytest.mark.parametrize("members, n", [(1, 256), (3, 256), (2048, 256), (1, 8), (3, 33),
                                        (1000, 64), (31, 100)])
def test_horner_kernel_persistent_walk(cuda, members, n):
    """Batches smaller than, equal to a few and many times (with a ragged last
    round) the clusters the card co-schedules: each cluster walks its members."""
    planes = horner_problem(n, members, cuda)
    ur, ui = hp.horner_apply_bm(*planes, order=8)
    plain_r, plain_i = hp.horner_twin_bm(*planes, order=8)
    torch.cuda.synchronize()
    assert float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max())) <= TOL


@pytest.mark.parametrize("members, n", [(3, 1100), (2, 2048)])
def test_horner_kernel_above_1024(cuda, members, n):
    """Dimensions past one thread per output (the kernel refused n > 1,024
    before): the streaming kernel, each thread owning outputs i, i + 1,024."""
    planes = horner_problem(n, members, cuda)
    before = launches("horner_apply_launch")
    ur, ui = hp.horner_apply_bm(*planes, order=8)
    plain_r, plain_i = hp.horner_twin_bm(*planes, order=8)
    torch.cuda.synchronize()
    assert launches("horner_apply_launch") == before + 1
    assert float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max())) <= TOL


def test_poly_sweep_auto_route_above_1024(cuda):
    """``sweep_expm_magnus_poly(horner="auto")`` at n = 1,040 (solve_dim of a
    dimension-33 Lindblad model is 1,089) runs through the kernel and agrees
    with the einsum route: Magnus-2, one operator, 2 steps, 4 members."""
    n, members, steps = 1040, 4, 2
    gen = np.random.default_rng(1040)

    def hermitian():
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return (a + a.conj().T) / (2 * np.sqrt(n))

    static, ops = -1j * hermitian(), -1j * hermitian()[None]
    coef = gen.uniform(-1, 1, (steps, 2, 1, members)).astype(np.float32)
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)
    coef = torch.as_tensor(coef, device=cuda)
    before = launches("horner_apply_launch")
    out = psw.sweep_expm_magnus_poly(static, ops, None, coef, y0, dt=0.1, horner="auto")
    torch.cuda.synchronize()
    assert launches("horner_apply_launch") == before + steps
    ref = psw.sweep_expm_magnus_poly(static, ops, None, coef, y0, dt=0.1, horner="einsum")
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (n, members)
    assert float((out - ref).abs().max()) <= TOL


def _h2d_copy_bytes(fn, path):
    """``fn()`` under ``torch.profiler``, and the byte counts of its
    host-to-device copies in the Chrome trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [ev["args"]["bytes"] for ev in events
                 if ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", "")]


def test_poly_sweep_cache_hit_uploads_nothing(cuda, tmp_path):
    """At the open-system cell's shape (n = 256, Magnus-3, one operator:
    Q = 24) a second call on the same operator tensors issues no
    host-to-device copy above 64 KB, and its output equals an uncached
    call's bit for bit. The first call's upload of the planes shows that the
    trace sees such copies."""
    n, members, steps = 256, 64, 3
    gen = np.random.default_rng(256)

    def hermitian():
        a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
        return (a + a.conj().T) / (2 * np.sqrt(n))

    static = torch.as_tensor(-1j * hermitian(), device=cuda)
    ops = torch.as_tensor(-1j * hermitian()[None], device=cuda)
    frame = torch.as_tensor(1j * 2 * np.pi * np.sort(gen.uniform(0.0, 5.0, n)), device=cuda)
    coef = torch.as_tensor(gen.uniform(-1, 1, (steps, 3, 1, members)), device=cuda).float()
    y0 = gen.normal(size=(n, members)) + 1j * gen.normal(size=(n, members))
    y0 = torch.as_tensor(y0 / np.linalg.norm(y0, axis=0), device=cuda)

    def call():
        out = psw.sweep_expm_magnus_poly(static, ops, frame, coef, y0, dt=0.08, magnus_order=3)
        torch.cuda.synchronize()
        return out

    psw._PREPARED_CACHE.clear()
    psw._EXPANSION_CACHE.clear()
    first, first_copies = _h2d_copy_bytes(call, tmp_path / "miss.json")
    gather = next(iter(psw._PREPARED_CACHE.values()))[0]
    assert gather.shape[0] == 24
    before = launches("horner_apply_launch")
    second, second_copies = _h2d_copy_bytes(call, tmp_path / "hit.json")
    assert launches("horner_apply_launch") == before + steps  # the kernel route
    assert max(first_copies) > 1 << 16
    assert max(second_copies, default=0) <= 1 << 16, second_copies
    psw._PREPARED_CACHE.clear()
    psw._EXPANSION_CACHE.clear()
    uncached = call()
    assert torch.equal(second, uncached) and torch.equal(first, uncached)


@pytest.mark.parametrize("n", [64, 100, 256])
def test_horner_streaming_kernel_matches_plain(cuda, n):
    planes = horner_problem(n, 37, cuda)
    ur, ui = hp._launch_kernel(*planes, 8, force_stream=True)
    plain_r, plain_i = hp.horner_twin_bm(*planes, order=8)
    torch.cuda.synchronize()
    assert float(torch.maximum((ur - plain_r).abs().max(), (ui - plain_i).abs().max())) <= TOL


def test_horner_gradient_uses_plain_backward(cuda):
    planes = [x.requires_grad_(True) for x in horner_problem(64, 5, cuda)]
    ur, ui = hp.horner_apply_bm_ad(*planes, order=8)
    (ur.sum() + 2.0 * ui.sum()).backward()
    twins = [x.detach().clone().requires_grad_(True) for x in planes]
    plain_r, plain_i = hp.horner_twin_bm(*twins, order=8)
    (plain_r.sum() + 2.0 * plain_i.sum()).backward()
    for got, want in zip(planes, twins):
        assert torch.equal(got.grad, want.grad)  # the same backward on the same inputs


def test_horner_kernel_rejects(cuda):
    planes = horner_problem(8, 3, cuda)
    with pytest.raises(TypeError, match="left from A8"):
        hp.horner_apply_bm(*[x.double() for x in planes])
    with pytest.raises(ValueError, match="shape mismatch"):
        hp.horner_apply_bm(planes[0], planes[1], planes[2], planes[3][:, :4])
    n = hp._LIB.horner_apply_max_n() + 1  # 1.7 GB of planes, never filled
    big = [torch.empty((1, n, n), device=cuda) for _ in range(2)]
    big += [torch.empty((1, n), device=cuda) for _ in range(2)]
    with pytest.raises(ValueError, match=f"n <= {n - 1}"):
        hp.horner_apply_bm(*big)
