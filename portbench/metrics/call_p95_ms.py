"""call_p95_ms: the 95th percentile (linear interpolation) of every call's
time in the window, host clock from the call's start to the synchronize
after it."""
import numpy as np


def read(run):
    if len(run.calls) < 20:  # fewer than one call beyond the 95th percentile
        return None
    return float(np.percentile([(e - s) * 1e3 for s, e in run.calls], 95))
