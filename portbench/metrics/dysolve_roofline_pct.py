"""dysolve_roofline_pct: the least time the card needs for a perturbative
sweep call's work (``portbench/counts/dysolve.py``: the monomials, the
contraction, Magnus's ``expm`` and ``Udt`` product, the chain), over the
device busy time of that call (every device operation inside the traced
calls), in percent. The lanes (steps x members) and the expansion's terms
come from the port's counters ``pert.step_lanes`` and ``pert.monomials``
(``qiskit_dynamics_tpu_torch.utils.metrics``, which count while the
profiler records), n and the method from the ``sweep.engine`` spans of the
perturbative ``solve_sweep``, the signals and Chebyshev order from the
cell's shape. A program without them reports nothing."""
from portbench.counts import dysolve, roofline


def read(run):
    if run.trace is None or not run.trace["call_busy_s"]:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    counters = getattr(metrics, "counters", None)
    records = getattr(metrics, "span_records", None)
    if counters is None or records is None:
        return None
    start = int(run.window_start * 1e9)
    passes = [r for r in records()
              if r.name == "sweep.engine" and "monomials" in r.attrs and r.start_ns >= start]
    counts = counters()
    lanes, terms = counts.get("pert.step_lanes", 0), counts.get("pert.monomials", 0)
    if not passes or not lanes or not terms:
        return None
    n, method = int(passes[-1].attrs["n"]), passes[-1].attrs["method"]
    shape = run.sweep_shape()
    n_vars = dysolve.variables(shape["k"], shape["chebyshev_order"])
    calls = run.trace["calls"]
    lanes_per_call = lanes / calls
    flops = dysolve.flops_per_lane(n, method, terms / len(passes), n_vars) * lanes_per_call
    nbytes = dysolve.nbytes(n, method, terms / len(passes), n_vars, lanes_per_call, run.members)
    least_s, _ = roofline.bound(flops, nbytes)
    return 100.0 * least_s / (run.trace["call_busy_s"] / calls)
