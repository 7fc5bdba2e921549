"""sweep_roofline_pct: the least time the card needs for the algorithm's
work in one call (``portbench/counts/<work>.py``, from the cell's shapes, at
the published FP32 and HBM peaks), over the device busy time of that call
(every device operation inside the traced calls, whatever its name), in
percent. Cells whose traffic names no ``work`` do not report it."""
import importlib

from portbench.counts import roofline


def read(run):
    work = run.traffic.get("work")
    if not work or run.trace is None or not run.trace["call_busy_s"]:
        return None
    flops, nbytes = importlib.import_module(f"portbench.counts.{work}").work(run.sweep_shape())
    least_s, _ = roofline.bound(flops, nbytes)
    return 100.0 * least_s / (run.trace["call_busy_s"] / run.trace["calls"])
