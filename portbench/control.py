"""The control of a cell's comparison, and the program's readings beside it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--side control|program]

For each seed, on the cell's first amplitude set (one whole call's members,
at the cell's own size): the control is the reference put in the program's
place and computed in the precision below the configuration's (float32, TF32
off): complex64 with every matrix product in TF32 (``Arith("tf32")``), in
blocks of members. It is read with the numbers a run compares, against the
float64 reference: ``state_err`` at ``probes`` members drawn from the seed,
``grad_err`` in a value-and-gradient cell, and ``norm_err`` over every
member. A sound comparison reads the control above the cell's limits. With
``--side program`` the program's own call on the same set is read the same way.
One JSON line per seed and side. The benchmark's runs do not run this.
"""
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import harness, reference, spec  # noqa: E402
from portbench import model as model_mod  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402

BLOCK_ELEMS = 1 << 24  # members x n^2 per block of the control
GRAD_BLOCK_ELEMS = 1 << 17  # the same under autograd, which keeps every step's products


def control_call(model, tr, amps, device):
    """The TF32 control over every member: (y, grad or None, deviation)."""
    problem = reference.Problem(model, device)
    steps = reference.fixed_steps(model.t_final, float(tr["reference"]["max_dt"]))
    order = int(tr["reference"]["magnus_order"])
    arith = reference.Arith("tf32")
    grad = tr["entry"] == "value_and_grad"
    block = max(1, (GRAD_BLOCK_ELEMS if grad else BLOCK_ELEMS) // (problem.n * problem.n))
    ys, gs = [], []
    for start in range(0, amps.shape[0], block):
        a = amps[start:start + block]
        if grad:
            a = a.detach().clone().requires_grad_(True)
            y = reference.solve(problem, a, 0.0, model.t_final, steps, order, arith)
            loss = (y[:, tr["loss_index"]].abs() ** 2).sum() / tr["members"]
            (g,) = torch.autograd.grad(loss, a)
            ys.append(y.detach())
            gs.append(g)
        else:
            with torch.no_grad():
                ys.append(reference.solve(problem, a, 0.0, model.t_final, steps, order, arith))
    y = torch.cat(ys)
    return y, (torch.cat(gs) if gs else None), harness.deviation(torch, y, model.vectorized)


def read_side(cell, model, seed, device, side, probes=None):
    tr = cell.traffic
    traffic = Traffic(tr, seed, device)
    amps = traffic.sets[0]
    start = time.perf_counter()
    if side == "control":
        y, g, dev = control_call(model, tr, amps, device)
    else:
        y, g = harness.program_module(tr).Program(model, tr, device).call(amps)
        dev = harness.deviation(torch, y, model.vectorized)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    pick = torch.Generator(device="cpu")
    pick.manual_seed(int(seed) % (1 << 64))
    count = int(probes or tr["probes"])
    probes = torch.randperm(amps.shape[0], generator=pick)[:count].to(amps.device)
    values = harness.readings(model, tr, amps[probes], y[probes],
                              None if g is None else g[probes], dev[None], device)
    return dict(side=side, seed=seed, seconds=seconds, **values)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--side", choices=("control", "program"), default="control")
    p.add_argument("--probes", type=int, default=None,
                   help="members compared (default: the cell's probes)")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    model = model_mod.build(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = read_side(cell, model, seed, device, args.side, args.probes)
        row.update(workload=args.workload, limits=cell.traffic["limits"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
