"""launches_per_call.fwd: device operations (kernels, copies, fills) that
start inside a traced call, per call, from the profiler's trace; the
forward cells."""


def read(run):
    if run.entry != "forward" or run.trace is None or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.trace["calls"]
