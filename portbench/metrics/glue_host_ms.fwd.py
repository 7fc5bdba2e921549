"""glue_host_ms.fwd: the host time of a traced forward call spent outside
its engine, in ms: for each ``sweep.call`` span the program recorded in the
window (``qiskit_dynamics_tpu_torch.utils.metrics``, which records while the
profiler does), its duration less that of the call's ``sweep.engine`` spans
(the launches, or the polynomial engine's step loop); the mean over calls.
A program that records no spans reports nothing."""


def read(run):
    if run.entry != "forward" or run.trace is None:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    records = getattr(metrics, "span_records", None)
    if records is None:
        return None
    start = int(run.window_start * 1e9)
    spans = [r for r in records() if r.start_ns >= start]
    calls = {r.id: r.end_ns - r.start_ns for r in spans if r.name == "sweep.call"}
    if not calls:
        return None
    for r in spans:
        if r.name == "sweep.engine" and r.call in calls:
            calls[r.call] -= r.end_ns - r.start_ns
    return 1e-6 * sum(calls.values()) / len(calls)
