"""qiskit_dynamics_tpu_torch: the PyTorch/CUDA port of qiskit_dynamics_tpu.

Same module paths and names as the JAX package (``qiskit_dynamics_tpu``),
written in PyTorch's idiom: models hold their operators as tensors on an
explicit ``device`` with an explicit ``dtype``, plain functions operate on
tensors, and the hot loop of the sweep solver is a CUDA kernel written for
Hopper (``csrc/``), with an eager-PyTorch twin for tensors on the CPU.

This package never imports ``jax``.

Entry points work on the CUDA device unless the caller passes
``device="cpu"`` (``device=None`` raises on a machine without one).

Ported so far: signals, the dense rotating frame (with its vectorized maps),
the dense and vectorized-Lindblad operator collections, generator,
Hamiltonian and vectorized Lindblad models, the RWA, the lockstep-adaptive
dopri5 sweep (kernel B1 and twin), the fixed-step Magnus-2 sweep (kernel B2,
plain version, eager engine, autograd wrapper), the fused sweep glue of both,
scipy host solves, ``Solver`` and ``benchmarks.cr_solver``; the large-dim
engines (kernels B3, B4); the perturbation package (``ArrayPolynomial``,
``solve_lmde_perturbation``) and the perturbative solvers ``DysonSolver`` and
``MagnusSolver`` with their sweep on the streamed propagator chain (kernel
B5) and the batched Taylor ``expm`` and its backward (kernels B6, B7, B10);
the high-precision family in native FP64: ``fused_sweep_solve(precision="df32")``
on kernel B8, the Chebyshev-interpolated sweeps, and the perturbative sweeps
with ``precision="df32"`` on the complex128 kernels B5 and B6; the fused
expm chain (kernel B9) with ``expm_taylor`` and ``benchmarks.expm_chain``,
and the device methods of ``solve_ode``/``solve_lmde`` (fixed-step Magnus and
RK4, Lanczos, parallel, adaptive dopri5/DOP853) with per-solve metrics, and
spans and counters on the sweep path (``utils.metrics``).
``ROADMAP.md`` lists what is still to come.
"""
import torch as _torch

# The JAX package pins jax_default_matmul_precision="highest": reduced
# precision matmul inputs wreck propagator chains. TF32 keeps ~3 decimal
# digits, so it stays off for both matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .exceptions import DynamicsError
from .models import RotatingFrame, HamiltonianModel, LindbladModel
from .signals import Signal, SignalSum, SignalList
from .solvers import (
    solve_ode,
    solve_lmde,
    Solver,
    OdeResult,
    fused_adaptive_sweep_solve,
    fused_sweep_solve,
    interpolated_sweep_solve,
    interpolated_sweep_solve_2d,
    DysonSolver,
    MagnusSolver,
    ExpansionModel,
)
from .perturbation import solve_lmde_perturbation, ArrayPolynomial

from . import models
from . import signals
from . import solvers
from . import ops
from . import perturbation
from . import utils
