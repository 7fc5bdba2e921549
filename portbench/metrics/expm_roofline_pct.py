"""expm_roofline_pct: kernel B6's (the batched Taylor ``expm`` of the
Magnus sweep, ``csrc/batched_linalg.cu``) least time for one call over its
own device time a call, in percent. The least time is its operations (as
``chip_smoke.py``'s B6 row bounds it): over the T x members step lanes, the
Taylor-12 ``expm`` by Horner's rule and its one squaring, 12 complex n x n
products of 8 n^3 each, at the published FP32 peak (its bytes: each lane's
matrix read and its exponential written, complex64). Its time is the traced
window's device operations whose name holds the forward kernel's name (the
trace's ten largest by name), over the traced calls; the shape is the
cell's. A trace without B6 reports nothing."""
from portbench.counts import dysolve, roofline

KERNELS = ("expm_lane_kernel", "expm_bol_kernel")  # n <= 16, and the tiled kernel above


def read(run):
    if run.trace is None or not run.trace["calls"]:
        return None
    kernel_s = sum(s for name, s in run.trace["device_ops"]
                   if any(kernel in name for kernel in KERNELS))
    if not kernel_s:
        return None
    shape = run.sweep_shape()
    n, lanes = shape["n"], shape["steps"] * shape["members"]
    products = dysolve.EXPM_ORDER - 1 + dysolve.EXPM_SQUARINGS
    least_s, _ = roofline.bound(products * 8.0 * n**3 * lanes, 16.0 * n * n * lanes)
    return 100.0 * least_s / (kernel_s / run.trace["calls"])
