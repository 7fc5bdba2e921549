"""device_idle_pct.grad: 100 (1 - the union of device operations inside the
traced calls / the calls' wall time), from the profiler's trace; the
value_and_grad cells."""


def read(run):
    if run.entry != "value_and_grad" or run.trace is None or not run.trace["call_busy_s"]:
        return None
    return 100.0 * (1.0 - run.trace["call_busy_s"] / run.trace["call_s"])
