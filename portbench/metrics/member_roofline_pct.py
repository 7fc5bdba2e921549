"""member_roofline_pct: kernel B3's (the member-major Magnus sweep,
``csrc/member_sweep.cu``) least time for one call over its own device time
a call, in percent. The least time is the bound B3's design is held to
(``portbench/counts/magnus_member.py::tf32x3``): its products as three TF32
passes on the tensor cores, the rest at the FP32 rate, or its bytes; the
FP32 bound would read a B3 at 73% of it already. The work is that of the
step lanes (steps x members) the port's counter ``member.step_lanes``
counted, with n, k, the rule, ``hermitian``, steps and members of a pass
from B3's ``sweep.engine`` spans (``qiskit_dynamics_tpu_torch.utils.metrics``,
which record while the profiler does) and the Horner order from the cell's
shape. Its time is the traced window's device operations whose name holds
one of B3's two kernels (the sweep, and the tables kernel that forms the
rotated tables the bound counts), over the traced calls. A trace without B3,
or a program without the counter or the spans' attributes, reports
nothing."""
from portbench.counts import magnus_member

KERNELS = ("member_sweep_kernel", "member_tables_kernel")


def read(run):
    if run.trace is None or not run.trace["calls"]:
        return None
    kernel_s = sum(s for name, s in run.trace["device_ops"]
                   if any(kernel in name for kernel in KERNELS))
    if not kernel_s:
        return None
    from qiskit_dynamics_tpu_torch.utils import metrics

    counters = getattr(metrics, "counters", None)
    records = getattr(metrics, "span_records", None)
    if counters is None or records is None:
        return None
    start = int(run.window_start * 1e9)
    passes = [r for r in records()
              if r.name == "sweep.engine" and "magnus" in r.attrs and r.start_ns >= start]
    lanes = counters().get("member.step_lanes", 0)
    if not passes or not lanes:
        return None
    attrs = passes[-1].attrs
    shape = dict(n=int(attrs["n"]), k=int(attrs["k"]), magnus_order=int(attrs["magnus"]),
                 hermitian=bool(attrs["hermitian"]), steps=int(attrs["steps"]),
                 members=int(attrs["members"]), order=int(run.sweep_shape()["order"]))
    least_s, _ = magnus_member.tf32x3(shape)
    calls = run.trace["calls"]
    passes_per_call = lanes / calls / (shape["steps"] * shape["members"])
    return 100.0 * least_s * passes_per_call / (kernel_s / calls)
