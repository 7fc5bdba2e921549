"""Shared helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy. The JAX side runs on the CPU with x64 (``conftest.py``)
and its Pallas kernels in interpret mode. Importing this module caps torch
at two threads, so the test workers do not oversubscribe the CPU.
"""
import numpy as np
import torch

torch.set_num_threads(2)

# float32 ulp, for the step-record comparison below
EPS32 = float(np.finfo(np.float32).eps)


def rng(seed: int = 1234) -> np.random.Generator:
    return np.random.default_rng(seed)


def random_hermitian(gen: np.random.Generator, n: int) -> np.ndarray:
    a = gen.normal(size=(n, n)) + 1j * gen.normal(size=(n, n))
    return (a + a.conj().T) / 2


def to_np(x) -> np.ndarray:
    """numpy view of a torch tensor or anything array-like (JAX arrays included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def assert_rel_close(actual, expected, rtol: float):
    """max |actual - expected| <= rtol * max(max |expected|, 1): relative for
    the O(1) quantities compared here, absolute where ``expected`` is a
    cancellation near zero (e.g. a static term with the frame subtracted)."""
    actual, expected = to_np(actual), to_np(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = max(float(np.max(np.abs(expected))), 1.0)
    err = float(np.max(np.abs(actual - expected)))
    assert err <= rtol * scale, f"max abs err {err:.3e} > {rtol:.1e} * {scale:.3e}"


def jax_kernel_data(jax_model, t_span):
    """(static, operators, omega) in the frame basis, as the JAX glue hands
    them to its kernel, as numpy."""
    from qiskit_dynamics_tpu.solvers.fused_sweep import _extract_generator_data

    _, _, static_fb, ops_fb, omega, _, _ = _extract_generator_data(jax_model, t_span, "parity")
    return np.asarray(static_fb), np.asarray(ops_fb), np.asarray(omega)


def step_records_agree(reference, port, boundaries, rtol: float, rtol_after_clip: float = 1e-2):
    """Compare per-tile accepted-step records (n_tiles, max_steps).

    ``boundaries`` are the elapsed times steps are clipped to (envelope-cell
    edges, eval times, tf).

    - The JAX kernel keeps its step size in float32; where a step is clipped
      to a boundary that f32 step can stop a few f32 ulps short, and the
      kernel then takes a sliver step of that size. The port's float64 steps
      land exactly, so steps shorter than 16 f32 ulps of the horizon are
      dropped from the reference before counting.
    - Steps clipped to a boundary, and the step right after each, are held
      to ``rtol_after_clip`` instead of ``rtol``: the step after a clipped
      step is ``max(proposal, h * factor)``, with ``factor`` taken from the
      error estimate of the SHORT clipped step, which f32 roundoff dominates
      in both kernels; the time error that leaves is absorbed by the next
      clipped step, whose size is the remaining gap. Steps are measured
      against the tile's median step where they are far shorter.

    Returns a list of failure messages (empty when the records agree).
    """
    reference, port = to_np(reference).astype(np.float64), to_np(port)
    boundaries = np.asarray(boundaries, dtype=np.float64)
    sliver = 16 * EPS32 * max(1.0, float(boundaries.max()))
    failures = []
    for tile, (ref_row, port_row) in enumerate(zip(reference, port)):
        ref_steps = ref_row[ref_row > sliver]
        port_steps = port_row[port_row > 0]
        if ref_steps.size != port_steps.size:
            failures.append(f"tile {tile}: {ref_steps.size} vs {port_steps.size} steps")
            continue
        ends = np.cumsum(ref_steps)
        clipped = np.min(np.abs(ends[:, None] - boundaries[None, :]), axis=1) < 1e-5
        loose = clipped | np.concatenate([[False], clipped[:-1]])
        scale = np.maximum(ref_steps, np.median(ref_steps))
        rel = np.abs(ref_steps - port_steps) / scale
        bound = np.where(loose, rtol_after_clip, rtol)
        if np.any(rel > bound):
            i = int(np.argmax(rel / bound))
            failures.append(f"tile {tile}: step {i} differs by {rel[i]:.2e} relative")
    return failures
