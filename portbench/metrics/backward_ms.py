"""backward_ms: the mean time of ``torch.autograd.grad`` in a
value-and-gradient call (the adjoint, ``ops/sweep_ad.py``), host clock
between two synchronizes, in the traced run."""


def read(run):
    times = run.spans.get("backward")
    if not times or run.trace is None:
        return None
    return 1e3 * sum(times) / len(times)
