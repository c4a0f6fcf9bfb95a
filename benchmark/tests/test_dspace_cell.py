"""The cell ``w8a.dspace_krylov``: its six per-layer readers on hand-made
logs and traces and on a CPU run of the cell with spans on, the d-space
reference's imports, and the bits of the whole w8a-like problem."""

import ast
import hashlib
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark import datagen, harness, peaks
from krylov_crn_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[2]
CELL = "w8a.dspace_krylov"
READERS = ("step_ms.dspace", "matvecs_per_step.dspace", "matvec_roofline",
           "device_idle.dspace", "crossing_it.dspace", "init_state_s.dspace")
SPAN_READERS = ("step_ms.dspace", "matvecs_per_step.dspace",
                "init_state_s.dspace")
MS = 1_000_000  # ns
# the kernel as torch.profiler names it
KERNEL = ("void (anonymous namespace)::matvec_stream<float, true>(float "
          "const*, float const*, float*, float*, int*, Geometry)")
# w8a's dense copies: A, and A^T at its 16-byte leading dimension
SHAPES = [(49749, 300, 300), (300, 49749, 49752)]


def _read(name, ctx):
    return harness.load_module(
        REPO / "benchmark" / "metrics" / f"{name}.py").read(ctx)


def _span(id, name, start_ms, end_ms, counts=None):
    rec = spans.Span(id, None, name, start_ms * MS, False, None)
    rec.end_ns = end_ms * MS
    rec.counts = counts or {}
    return rec


def _solve_log(log, t, steps, step_ms, launches=21):
    """One solve: its initial state, then ``steps`` steps ``step_ms``
    apart, each counting ``launches`` matvec launches."""
    log.append(_span(len(log), "krylov.init_state", t, t + 1))
    t += 1
    for _ in range(steps):
        log.append(_span(len(log), "krylov.step", t, t + step_ms - 0.5,
                         {"matvec.launches": launches}))
        t += step_ms
    return t


def _ctx(busy_s=0.03, window_s=0.05, kernels=None, shapes=SHAPES,
         solves=()):
    ctx = types.SimpleNamespace(profile={"busy_s": busy_s,
                                         "window_s": window_s,
                                         "kernels": kernels or {}},
                                solves=list(solves))
    if shapes is not None:
        ctx.matvec_shapes = shapes
    return ctx


@pytest.fixture
def log(monkeypatch):
    recs = []
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    return recs


def test_the_span_readers_take_steps_within_a_solve(log):
    # two solves, the gap between them not a step's
    t = _solve_log(log, 0, 17, 2)
    _solve_log(log, t + 500, 5, 4, launches=0)
    ctx = _ctx()
    assert _read("step_ms.dspace", ctx) == pytest.approx(
        (16 * 2 + 4 * 4) / 20)
    assert _read("matvecs_per_step.dspace", ctx) == pytest.approx(
        21 * 17 / 22)
    # one initial state a solve, 1 ms each
    assert _read("init_state_s.dspace", ctx) == pytest.approx(0.002)


def test_one_step_has_no_distance(log):
    _solve_log(log, 0, 1, 2)
    assert _read("step_ms.dspace", _ctx()) is None
    assert _read("matvecs_per_step.dspace", _ctx()) == 21


def test_the_roofline_is_the_bytes_of_a_call_over_its_mean_time():
    reader = harness.load_module(REPO / "benchmark/metrics/"
                                 "matvec_roofline.py")
    a, at = (reader.matvec_bytes(*s) for s in SHAPES)
    assert (a, at) == (59_898_996, 59_902_596)
    assert abs(a - at) / a < 1e-4
    # 21 calls of 30 us each, beside kernels that are not the matvec's
    kernels = {KERNEL: (21, 21 * 30e-6), "symv_upper_tiles": (3, 1.0),
               "elementwise_kernel": (100, 0.5)}
    share = _read("matvec_roofline", _ctx(kernels=kernels))
    assert share == pytest.approx(
        100 * (a + at) / 2 / peaks.HBM_BYTES_PER_S / 30e-6)
    assert 59 < share < 60


def test_the_crossing_is_the_mean_over_the_solves_that_crossed():
    solves = [{"crossing_it": 7}, {"crossing_it": None}, {"crossing_it": 8},
              {"solve_s": 0.04}]
    assert _read("crossing_it.dspace", _ctx(solves=solves)) == 7.5
    assert _read("crossing_it.dspace", _ctx(solves=solves[1:2])) is None


def test_the_idle_share_is_the_harness_s():
    assert _read("device_idle.dspace", _ctx(0.03, 0.05)) == pytest.approx(40)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_reads_nothing(log, name):
    # no spans, no matvec kernel in the trace, no dense copies, no trace
    assert _read(name, types.SimpleNamespace(profile=None, solves=[])) \
        is None
    if name in SPAN_READERS:
        assert _read(name, _ctx()) is None
    if name == "matvec_roofline":
        kernels = {KERNEL: (21, 21 * 30e-6)}
        assert _read(name, _ctx()) is None
        assert _read(name, _ctx(kernels=kernels, shapes=None)) is None
        assert _read(name, _ctx(kernels=kernels, shapes=[])) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "krylov_crn_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["krylov_crn_tpu_torch.utils"], "spans")
    assert _read(name, _ctx()) is None


def test_the_readers_find_the_spans_of_a_run(tiny_root, monkeypatch):
    """A CPU run of the cell with spans on: the span readers find the
    program's steps and initial states, the crossing reader the window's
    crossings; the CPU launches no matvec kernel, so the count is 0 (the
    card's is 21), and without a trace the device readers read
    nothing."""
    cell = harness.load_cell(CELL, tiny_root)
    assert {m["name"] for m in cell["per_layer"]} == set(READERS)
    seen = []
    metrics = harness._metrics

    def keep_ctx(ctx, entries, bench):
        seen.append(ctx)
        return metrics(ctx, entries, bench)

    monkeypatch.setattr(harness, "_metrics", keep_ctx)
    spans.clear()
    spans.enable()
    try:
        res = harness.run(CELL, 5, 0.1, False, root=tiny_root, device="cpu")
        assert res["correct"], res["checks"]
        crossing = _read("crossing_it.dspace", seen[0])
        assert crossing is not None and 0 < crossing <= 48
        ctx = types.SimpleNamespace(profile=None, solves=[])
        step_ms = _read("step_ms.dspace", ctx)
        assert step_ms is not None and 0 < step_ms < float("inf")
        init_s = _read("init_state_s.dspace", ctx)
        assert init_s is not None and init_s > 0
        assert _read("matvecs_per_step.dspace", ctx) == 0
        assert _read("matvec_roofline", ctx) is None
        assert _read("device_idle.dspace", ctx) is None
    finally:
        spans.disable()
        spans.clear()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_dspace_reference_imports_nothing_of_the_program():
    path = REPO / "benchmark" / "reference_dspace.py"
    for mod in _imports(path):
        assert mod.split(".")[0] not in (harness.PROGRAM,) + harness.FORBIDDEN
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "import benchmark.reference_dspace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & {harness.PROGRAM, *harness.FORBIDDEN}


# sha256 of (indptr int64, indices int64, data fp32, b fp64) of the whole
# w8a-like problem, as test_benchmark_run.PROBLEM_SHA256 holds the others
W8A_SHA256 = "c39eca11627201fa08977169d830498a3dc7b6b3169cf66f81871cd46a52823c"


def test_the_w8a_like_problem_keeps_its_bits():
    cfg = json.loads((REPO / "benchmark/configs/w8a-like.json").read_text())
    A, b = datagen.make(cfg)
    assert A.shape == (cfg["n_rows"], cfg["n_features"])
    assert A.nnz == cfg["nnz"]
    h = hashlib.sha256()
    for arr, dt in ((A.indptr, np.int64), (A.indices, np.int64),
                    (A.data, np.float32), (b, np.float64)):
        h.update(np.ascontiguousarray(arr, dt).tobytes())
    assert h.hexdigest() == W8A_SHA256
