"""BENCHMARK.json against its format, and the files it names."""
import json
import math
import re
import shutil
import subprocess
import sys

import pytest

from portbench import model as model_mod
from portbench import spec

BENCH = spec.load_benchmark()
NAME, UNIT = spec.NAME, spec.UNIT
CELLS = [w["name"] for w in BENCH["workloads"]]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _one_line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its budget at this length
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for name in names:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and (spec.ROOT / c["file"]).is_file()
        assert c["reduced"] == [] or all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_and_reports_enough(cell):
    c = spec.load_cell(cell)
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:  # each per-layer metric moves a metric its cell reports
        assert m.moves in names
    for m in c.end_to_end + c.per_layer:
        assert callable(m.reader().read)
    model = model_mod.build(c.config)
    assert model.dim == int(c.config["levels"]) ** len(c.config["freqs_ghz"])
    solve_dim = model.dim**2 if model.vectorized else model.dim
    assert solve_dim == c.config["solve_dim"]
    limits = c.traffic["limits"]
    assert set(limits) == ({"state_err", "norm_err", "grad_err"}
                           if c.traffic["entry"] == "value_and_grad" else {"state_err", "norm_err"})
    assert all(0 < v < 1 for v in limits.values())


def test_files_are_named_from_names():
    for path in (spec.ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A cell, a configuration and a metric added as new files and entries,
    with no other edit, run and report in a copy of the benchmark."""
    from tiny import copy_with, run_tiny, tiny_cell

    cfg = json.loads((spec.ROOT / "portbench/configs/cr_transmon_dim16.json").read_text())
    cfg.update(name="one_transmon_dim4", freqs_ghz=[5.0], anharmonicities_ghz=[-0.33],
               rwa_cutoff_ghz=2.5, solve_dim=4, drives=[dict(
                   transmon=0, carrier_ghz=5.0, operator_scale=1.0, envelope_scale=0.02)])
    root = copy_with(tmp_path, {
        "configs": [dict(name="one_transmon_dim4", source="https://example.org",
                         file="portbench/configs/one_transmon_dim4.json", reduced=[],
                         why="a test")],
        "workloads": [dict(name="rabi_scan", config="one_transmon_dim4", traffic="rabi_scan",
                           chips=1, why="a test")],
        "end_to_end": [dict(name="calls_per_window", unit="calls", better="higher", bound=0.05,
                            source="host_clock", workloads=["rabi_scan"])],
    })
    (root / "portbench/configs/one_transmon_dim4.json").write_text(json.dumps(cfg))
    shutil.copy(spec.ROOT / "portbench/workloads/cr_fixed_sweep.json",
                root / "portbench/workloads/rabi_scan.json")
    (root / "portbench/metrics/calls_per_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")

    result = run_tiny(tiny_cell("rabi_scan", root=root, members=3, t_final=2.0))
    assert result["correct"]
    assert result["metrics"]["calls_per_window"]["value"] == result["attempted"]
    # sims_per_s lists its cells; setup_s, listing none, is every cell's
    assert set(result["metrics"]) == {"calls_per_window", "setup_s"}


@pytest.mark.parametrize("traced", [False, True])
def test_the_gradient_cell_is_ready_by_entries_alone(tmp_path, traced):
    from tiny import GRAD_ENTRIES, copy_with, run_tiny, tiny_cell

    root = copy_with(tmp_path, GRAD_ENTRIES)
    result = run_tiny(tiny_cell("cr_grad_sweep", root=root), traced=traced)
    assert result["correct"], result["checks"]
    want = {"backward_ms"} if traced else {"grad_sims_per_s", "setup_s"}
    assert set(result["metrics"]) == want  # the CPU has no device trace to read
    assert set(result["checks"]) == {"state_err", "grad_err", "norm_err"}


@pytest.mark.parametrize("traced", [False, True])
def test_the_dysolve_cells_are_ready_by_files_and_entries_alone(tmp_path, traced):
    """BASELINE config 4's configuration and cells, added to a copy as
    files and entries with no other edit, load, run and report."""
    from tiny import DYSON_ENTRIES, copy_with, run_tiny, tiny_cell

    root = copy_with(tmp_path, DYSON_ENTRIES)
    for entry in DYSON_ENTRIES["configs"] + DYSON_ENTRIES["workloads"]:
        assert NAME.match(entry["name"]) and _one_line(entry["why"])
    for entry in DYSON_ENTRIES["configs"]:
        assert _one_line(entry["source"]) and (root / entry["file"]).is_file()
    for cell in ("dyson_sweep", "magnus_sweep"):
        c = spec.load_cell(cell, root)
        assert {m.name for m in c.end_to_end} == {"sims_per_s", "setup_s"}
        assert {m.name for m in c.per_layer} == {"launches_per_call.fwd", "device_idle_pct.fwd"}
        assert model_mod.build(c.config).dim == c.config["solve_dim"]
        result = run_tiny(tiny_cell(cell, root=root), traced=traced)
        assert result["correct"], result["checks"]
        # the CPU has no device trace to read
        assert set(result["metrics"]) == (set() if traced else {"sims_per_s", "setup_s"})


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_the_required_keys(traced):
    from tiny import run_tiny, tiny_cell

    result = run_tiny(tiny_cell("cr_fixed_sweep"), traced=traced)
    keys = list(result)
    assert set(keys) == LINE_KEYS | ({"breakdown"} if traced else set())
    assert keys[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and math.isfinite(check["value"])
    json.dumps(result)


def _run_cli(args, cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_cli(["--workload", "cr_amp_sweep", "--seed", str(2**31 + 5), "--seconds", "1",
                    "--trace", "0"], spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = _run_cli(["--workload", "cr_amp_sweep", "--seed", "1", "--seconds", "1",
                    "--trace", "0"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package(tmp_path):
    code = (
        "import pathlib, sys, time, torch\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r}); sys.path.insert(0, {str(spec.ROOT / 'portbench/tests')!r})\n"
        "import portbench.control, portbench.harness, portbench.program\n"
        "import portbench.envelopes.gaussian, portbench.programs.perturbative_sweep\n"
        "from tiny import DYSON_ENTRIES, copy_with, run_tiny, tiny_cell\n"
        "for cell in ('cr_fixed_sweep', 'cr_amp_sweep'):\n"
        "    run_tiny(tiny_cell(cell), traced=cell == 'cr_fixed_sweep')\n"
        f"root = copy_with(pathlib.Path({str(tmp_path)!r}), DYSON_ENTRIES)\n"
        "run_tiny(tiny_cell('magnus_sweep', root=root), traced=True)\n"
        "print(','.join(portbench.harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip("\n").split("\n")[-1] == ""
    from portbench.harness import FORBIDDEN

    # names are compared whole: the port's name begins with the JAX package's
    assert "qiskit_dynamics_tpu_torch".split(".")[0] not in FORBIDDEN
