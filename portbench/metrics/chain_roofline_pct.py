"""chain_roofline_pct: kernel B5's (the streamed propagator chain,
``csrc/chain_apply.cu``) least time for one call over its own device time a
call, in percent. The least time is its bytes (as ``chip_smoke.py``'s B5
row bounds it): the T x members complex64 step propagators of n x n read
once, the initial states read and the final states written, at the
published HBM peak. Its time is the traced window's device operations whose
name holds ``chain_apply`` (the trace's ten largest by name), over the traced
calls; the shape is the cell's. A trace without B5 reports nothing."""
from portbench.counts import roofline

KERNEL = "chain_apply"


def read(run):
    if run.trace is None or not run.trace["calls"]:
        return None
    kernel_s = sum(s for name, s in run.trace["device_ops"] if KERNEL in name)
    if not kernel_s:
        return None
    shape = run.sweep_shape()
    n, lanes = shape["n"], shape["steps"] * shape["members"]
    props = 8.0 * lanes * n * n
    least_s, _ = roofline.bound(props, props + 16.0 * n * shape["members"])
    return 100.0 * least_s / (kernel_s / run.trace["calls"])
