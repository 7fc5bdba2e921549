"""What decides ``correct``: the port agrees with the reference at a tiny
size, the TF32 control does not, and a run with the timed path broken
underneath reads ``correct`` false."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import control, spec
from portbench import model as model_mod
from tiny import GRAD_ENTRIES, TINY, copy_with, run_tiny, tiny_cell

LISTED = [w["name"] for w in spec.load_benchmark()["workloads"]]
CELLS = LISTED + [w["name"] for w in GRAD_ENTRIES["workloads"]]


@pytest.fixture
def cell_root(tmp_path):
    """The benchmark's root, or a copy with the gradient cell's entries."""
    def root(cell):
        return spec.ROOT if cell in LISTED else copy_with(tmp_path, GRAD_ENTRIES)
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_plain_versions_agree_with_the_reference(cell, cell_root):
    result = run_tiny(tiny_cell(cell, root=cell_root(cell)))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


# The control at a size a CPU test run holds: a few members, but every step
# of the cell (TF32's error grows with the steps), and at n = 256 fewer.
CONTROL_SIZE = {"cr_amp_sweep": 4, "cr_fixed_sweep": 16, "cr_grad_sweep": 8,
                "cr_pair_open_sweep": 2}


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_limits(cell, cell_root):
    c = spec.load_cell(cell, cell_root(cell))
    c.traffic.update(members=CONTROL_SIZE[cell], probes=CONTROL_SIZE[cell])
    model = model_mod.build(c.config)
    row = control.read_side(c, model, 2**31 + 101, torch.device("cpu"), "control")
    limits = c.traffic["limits"]
    assert any(row[name] > limits[name] for name in limits), row


def _unchanged(call):
    """The state returned unchanged: every member's final state is y0."""
    def broken(amps):
        y, g = call(amps)
        flat = torch.zeros_like(y).reshape(len(y), -1)
        flat[:, 0] = 1.0  # a basis state, as the configurations start in
        return flat.reshape(y.shape), None if g is None else torch.zeros_like(g)
    return broken


def _half_batch(call):
    """Half the batch left out, the mean taken over the rest."""
    def broken(amps):
        h = amps.shape[0] // 2
        y, g = call(amps[:h])
        rest = torch.zeros((amps.shape[0] - h,) + tuple(y.shape[1:]), dtype=y.dtype)
        g_rest = None if g is None else torch.zeros(amps.shape[0] - h, dtype=g.dtype)
        return torch.cat([y, rest]), None if g is None else torch.cat([g, g_rest])
    return broken


def _altered(call):
    """One answer altered where it is produced: a member's first amplitude."""
    def broken(amps):
        y, g = call(amps)
        flat = y.detach().reshape(len(y), -1).clone()
        flat[len(y) // 3, 0] += 1e-2
        return flat.reshape(y.shape), g
    return broken


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_incorrect(cell, fault, cell_root):
    # one chip: no exchange between chips to leave out
    result = run_tiny(tiny_cell(cell, root=cell_root(cell)), wrap=FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", LISTED)
def test_on_the_card_the_control_fails_and_the_program_passes(cell):
    """At the cell's own size on three seeds (``portbench/control.py``)."""
    seeds = [2**31 + 9001, 2**31 + 9002, 2**31 + 9003]
    limits = spec.load_cell(cell).traffic["limits"]
    for side, fails in (("control", True), ("program", False)):
        out = subprocess.run(
            [sys.executable, "portbench/control.py", "--workload", cell, "--side", side,
             "--seeds", ",".join(map(str, seeds))],
            cwd=spec.ROOT, capture_output=True, text=True, timeout=1800)
        assert out.returncode == 0, out.stderr[-3000:]
        rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
        assert len(rows) == len(seeds)
        for row in rows:
            over = any(row[name] > limits[name] for name in limits)
            assert over == fails, row


def test_tiny_sizes_cover_every_cell():
    assert set(TINY) == set(CELLS)
