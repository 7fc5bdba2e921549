"""Framework exception types (counterpart of ``qiskit_dynamics_tpu.exceptions``)."""


class DynamicsError(Exception):
    """Base error for qiskit_dynamics_tpu_torch."""


# Alias kept so user code written against the reference's error type ports over.
QiskitError = DynamicsError
