"""graph_hit_pct: 100 x the adaptive sweep calls that replayed their CUDA
graph over all the calls that looked one up, over the traced calls: the host
counters ``sweep.graph_hits`` over ``sweep.graph_hits`` +
``sweep.graph_misses`` (a capture) + ``sweep.graph_fallbacks`` (the eager
path) of ``qiskit_dynamics_tpu_torch.utils.metrics``, which count while the
profiler records. A program without them reports nothing."""

NAMES = ("sweep.graph_hits", "sweep.graph_misses", "sweep.graph_fallbacks")


def read(run):
    if run.trace is None:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    counters = getattr(metrics, "counters", None)
    if counters is None:
        return None
    counts = counters()
    total = sum(counts.get(name, 0) for name in NAMES)
    if not total:
        return None
    return 100.0 * counts.get("sweep.graph_hits", 0) / total
