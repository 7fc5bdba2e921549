"""The one boundary between the port and its CUDA kernels
(``qiskit_dynamics_tpu_torch/kernels/boundary.py``).

CPU tests: against a stub library (``_build.load`` and the CUDA stream calls
replaced), a tensor argument becomes its pointer and ``None`` or an empty
tensor a null pointer, a launch gets the current stream appended, a nonzero
code raises with the library's own string, each launch counts once (and a
capture none), a query's value comes back unchanged; every wrapper's table of
signatures matches the C prototypes in ``csrc/``.

Card test (marked ``cuda``): a CUDA graph capture through a wrapper counts no
launch and launches nothing; its replay gives the eager result. This file
imports nothing of JAX; on the card run it with ``--noconftest``.
"""
import contextlib
import ctypes
import re
from pathlib import Path

import pytest
import torch

from qiskit_dynamics_tpu_torch.kernels import Library, boundary, launches
from qiskit_dynamics_tpu_torch.ops import (
    adaptive_sweep,
    batched_linalg,
    chain_apply,
    df_sweep,
    expm_chain_pallas,
    horner_pallas,
    member_sweep,
    monomial_contract,
    sweep_solver,
)
from qiskit_dynamics_tpu_torch.utils import metrics

STREAM = 0x5EED
SIGNATURES = {
    "stub_launch": "p3 i d s",
    "stub_plan": "i p",
    "stub_bytes": "i2 -> q",
}


class StubFunction:
    """A library entry: records its arguments, returns ``result(*args)``."""

    def __init__(self, result):
        self.result, self.calls, self.argtypes, self.restype = result, [], None, None

    def __call__(self, *args):
        self.calls.append(args)
        return self.result(*args)


class StubLibrary:
    _name = "/stub/libstub.so"

    def __init__(self):
        self.code = 0
        self.entries = {
            "stub_launch": StubFunction(lambda *args: self.code),
            "stub_plan": StubFunction(lambda *args: self.code),
            "stub_bytes": StubFunction(lambda a, b: -(a * b)),
            "stub_error_string": StubFunction(lambda code: f"the stub's error {code}".encode()),
        }

    def __getitem__(self, name):
        return self.entries[name]


@pytest.fixture
def stub(monkeypatch):
    """A :class:`Library` over a stub: no build, no card. ``capturing`` sets
    what the stream reports."""
    lib = StubLibrary()
    lib.capturing = False
    monkeypatch.setattr(boundary._build, "load", lambda name, defines=(): lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": STREAM})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: lib.capturing)
    metrics.disable_metrics(clear=True)
    yield lib, Library("stub", SIGNATURES)
    metrics.disable_metrics(clear=True)


def test_tensors_become_pointers_and_empty_ones_null(stub):
    lib, kernels = stub
    full = torch.arange(6, dtype=torch.float32)
    kernels.stub_launch(None, torch.empty(0), full, 7, 0.25)
    assert lib.entries["stub_launch"].calls == [(None, None, full.data_ptr(), 7, 0.25, STREAM)]


def test_argument_and_result_types_follow_the_signature(stub):
    lib, kernels = stub
    kernels.stub_launch, kernels.stub_plan, kernels.stub_bytes  # bind all three
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    assert lib.entries["stub_launch"].argtypes == [p, p, p, i, d, p]
    assert lib.entries["stub_launch"].restype is i
    assert lib.entries["stub_plan"].argtypes == [i, p]
    assert lib.entries["stub_bytes"].argtypes == [i, i]
    assert lib.entries["stub_bytes"].restype is ctypes.c_longlong


def test_the_stream_is_appended_to_launches_only(stub):
    lib, kernels = stub
    out = torch.zeros(3, dtype=torch.int32)
    kernels.stub_plan(4, out)
    assert lib.entries["stub_plan"].calls == [(4, out.data_ptr())]
    kernels.stub_launch(out, out, out, 1, 2.0)
    assert lib.entries["stub_launch"].calls[-1][-1] == STREAM


def test_a_query_returns_its_value_unchanged(stub):
    lib, kernels = stub
    assert kernels.stub_bytes(3, 5) == -15  # a negative value is no error for a query
    assert launches("stub_bytes") == 0


@pytest.mark.parametrize("entry, args", [("stub_launch", (None, None, None, 0, 0.0)),
                                         ("stub_plan", (0, None))])
def test_a_nonzero_code_raises_with_the_library_string(stub, entry, args):
    lib, kernels = stub
    lib.code = 719
    with pytest.raises(RuntimeError, match=f"^{entry} failed: the stub's error 719$"):
        getattr(kernels, entry)(*args)
    assert lib.entries["stub_error_string"].calls == [(719,)]
    assert launches(entry) == 0  # a failed launch counts nothing


def test_each_launch_counts_once_whatever_the_switch(stub):
    lib, kernels = stub
    for _ in range(3):
        kernels.stub_launch(None, None, None, 0, 0.0)
    kernels.stub_plan(0, None)  # no stream: not a launch
    assert launches("stub_launch") == 3 and launches("stub_plan") == 0
    assert metrics.counters()["kernel.launches.stub_launch"] == 3
    metrics.reset_spans()
    kernels.stub_launch(None, None, None, 0, 0.0)
    assert launches("stub_launch") == 1


def test_a_capture_counts_nothing(stub):
    lib, kernels = stub
    lib.capturing = True
    kernels.stub_launch(None, None, None, 0, 0.0)
    assert len(lib.entries["stub_launch"].calls) == 1 and launches("stub_launch") == 0
    lib.capturing = False
    kernels.stub_launch(None, None, None, 0, 0.0)
    assert launches("stub_launch") == 1


def test_a_variant_loads_its_own_build(stub, monkeypatch):
    lib, kernels = stub
    loaded = []
    monkeypatch.setattr(boundary._build, "load",
                        lambda name, defines=(): loaded.append((name, defines)) or lib)
    variant = kernels.variant("STUB_PROFILE")
    variant.stub_bytes(1, 2)
    assert loaded == [("stub", ("STUB_PROFILE",))] and variant.path == StubLibrary._name
    with pytest.raises(AttributeError, match="no entry 'stub_missing'"):
        kernels.stub_missing  # noqa: B018


# ---------------------------------------------------------------------------
# every wrapper's signatures against the C prototypes of csrc/
# ---------------------------------------------------------------------------
CSRC = Path(boundary._build.SOURCE_DIR)
WRAPPERS = (adaptive_sweep, batched_linalg, chain_apply, df_sweep, expm_chain_pallas,
            horner_pallas, member_sweep, monomial_contract, sweep_solver)
LIBRARIES = [lib for module in WRAPPERS for lib in vars(module).values()
             if isinstance(lib, Library)]
RESULTS = {"": "int", "i": "int", "q": "long long", "z": "size_t"}


def _prototypes(source: str) -> dict:
    """entry -> (result type, parameter letters) of the extern "C" functions."""
    body = source[source.index('extern "C" {'):]
    found = {}
    pattern = r"^(const char\*|int|long long|size_t)\s+(\w+)\(([^)]*)\)\s*\{"
    for result, name, params in re.findall(pattern, body, flags=re.M):
        letters = ""
        for param in (p.strip() for p in params.split(",") if p.strip()):
            if re.fullmatch(r"void\*\s*stream", param):
                letters += "s"
            elif "*" in param:
                letters += "p"
            else:
                ctype = param.rsplit(None, 1)[0]
                letters += {"int": "i", "long long": "q", "double": "d", "float": "f"}[ctype]
        found[name] = (result, letters)
    return found


def test_every_kernel_library_has_one_table():
    assert sorted(lib.name for lib in LIBRARIES) == sorted(p.stem for p in CSRC.glob("*.cu"))


@pytest.mark.parametrize("lib", LIBRARIES, ids=lambda lib: lib.name)
def test_signatures_match_the_c_prototypes(lib):
    prototypes = _prototypes((CSRC / f"{lib.name}.cu").read_text())
    assert prototypes[f"{lib.name}_error_string"][0] == "const char*"
    for entry, signature in lib.signatures.items():
        args, _, result = signature.partition("->")
        letters = "".join(t[0] * int(t[1:] or 1) for t in args.split())
        assert prototypes[entry] == (RESULTS[result.strip()], letters), entry
        assert "s" not in letters[:-1], f"{entry}: the stream is the last argument"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_a_graph_capture_counts_no_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(20)
    props = torch.randn((5, 4, 4, 256), dtype=torch.complex64, device="cuda", generator=gen)
    y0 = torch.randn((4, 256), dtype=torch.complex64, device="cuda", generator=gen)
    want = chain_apply.chain_apply_bol(props, y0)  # builds the library, counts one
    before = launches("chain_apply_launch")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain_apply.chain_apply_bol(props, y0)
    assert launches("chain_apply_launch") == before
    graph.replay()  # a bare graph: its owner counts its replays
    torch.cuda.synchronize()
    assert torch.equal(out, want) and launches("chain_apply_launch") == before
    chain_apply.chain_apply_bol(props, y0)
    assert launches("chain_apply_launch") == before + 1
