"""accepted_step_share: 100 x the steps kernel B1 (or its eager twin)
accepted over the steps it attempted, summed over tiles and over the traced
calls: the counters ``b1.steps_accepted`` and ``b1.steps_attempted`` of
``qiskit_dynamics_tpu_torch.utils.metrics``, which count while the profiler
records. A program without them reports nothing."""


def read(run):
    if run.trace is None:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    counters = getattr(metrics, "counters", None)
    if counters is None:
        return None
    counts = counters()
    attempted = counts.get("b1.steps_attempted", 0)
    if not attempted:
        return None
    return 100.0 * counts.get("b1.steps_accepted", 0) / attempted
