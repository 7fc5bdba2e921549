"""The benchmark of ``qiskit_dynamics_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``portbench/control.py``
runs the correctness control. Only :mod:`portbench.program` and
``portbench/programs/`` import the port; nothing here imports ``jax`` or the
JAX package.
"""
