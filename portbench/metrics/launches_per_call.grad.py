"""launches_per_call.grad: device operations (kernels, copies, fills) that
start inside a traced call, per call, from the profiler's trace; the
value_and_grad cells."""


def read(run):
    if run.entry != "value_and_grad" or run.trace is None or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.trace["calls"]
