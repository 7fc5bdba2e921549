"""adaptive_roofline_pct: the least time the card needs for kernel B1's
work in one call, over the device busy time of that call (every device
operation inside the traced calls), in percent. The work
(``portbench/counts/adaptive_dopri5.py``) counts the accepted steps of one
launch, summed over its tiles: the counter ``b1.steps_accepted`` of
``qiskit_dynamics_tpu_torch.utils.metrics`` over the launches recorded as
B1's ``sweep.engine`` spans, which also give ``tile_b`` and the lanes; n and
k come from the configuration. A program without them reports nothing."""
from portbench.counts import adaptive_dopri5, roofline


def read(run):
    if run.trace is None or not run.trace["call_busy_s"]:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    counters = getattr(metrics, "counters", None)
    records = getattr(metrics, "span_records", None)
    if counters is None or records is None:
        return None
    launches = [r for r in records() if r.name == "sweep.engine" and "tile_b" in r.attrs]
    accepted = counters().get("b1.steps_accepted", 0)
    if not launches or not accepted:
        return None
    tile_b, lanes = int(launches[-1].attrs["tile_b"]), int(launches[-1].attrs["lanes"])
    model = run.model
    n = model.dim * model.dim if model.vectorized else model.dim
    # the RWA splits each drive into the parts of its real and imaginary envelope
    k = len(model.drives) * (2 if model.rwa_cutoff_ghz is not None else 1)
    flops = adaptive_dopri5.flops(n, k, tile_b, [accepted / len(launches)])
    least_s, _ = roofline.bound(flops, adaptive_dopri5.nbytes(n, k, lanes))
    return 100.0 * least_s / (run.trace["call_busy_s"] / run.trace["calls"])
