"""The per-layer metrics that read the program's span log, on hand-made
logs: each sums or averages the spans it names, host spans inside host
spans count once in the unnamed idle share, and an empty log (a program
without spans) reads nothing."""

import sys
import types
from pathlib import Path

import pytest

from benchmark import harness
from krylov_crn_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[2]

READERS = ("init_state_s.gram", "reinject_s.gram", "certify_eval_s.gram",
           "idle_unnamed.gram", "draw_ms.sscn", "blocks_per_step.sscn",
           "idle_unnamed.sscn")
MS = 1_000_000  # ns


def _read(name, ctx):
    return harness.load_module(
        REPO / "benchmark" / "metrics" / f"{name}.py").read(ctx)


def _span(id, name, start_ms, end_ms, parent=None, host=False,
          drained=None, counts=None):
    rec = spans.Span(id, parent, name, start_ms * MS, host, drained)
    rec.end_ns = end_ms * MS
    rec.counts = counts or {}
    return rec


def _ctx(busy_s=1.0, window_s=10.0):
    return types.SimpleNamespace(
        profile={"busy_s": busy_s, "window_s": window_s})


def _gram_log():
    """A Gram solve: init_run (host init_state 500 ms drained, the build
    with its drained packing 100 ms), run_fused (a fetch, two reinjections
    of 200 ms and a rollback of 100 ms, certification: a fetch and two
    evaluations of 3 s, one holding a host span of its own)."""
    return [
        _span(0, "gram.init_run", 0, 900),
        _span(1, "gram.init_state", 0, 500, 0, True, True),
        _span(2, "gram.build_K", 500, 900, 0),
        _span(3, "gram.build_K.pack", 500, 600, 2, True, True),
        _span(4, "gram.run_fused", 1000, 9900),
        _span(5, "gram.fetch", 1100, 1200, 4),
        _span(6, "gram.reinject", 1200, 1400, 4, True, True),
        _span(7, "gram.reinject", 1500, 1700, 4, True, True),
        _span(8, "gram.rollback", 1700, 1800, 4, True, False),
        _span(9, "gram.certify", 1800, 9900, 4),
        _span(10, "gram.certify.fetch", 1800, 1900, 9),
        _span(11, "gram.certify.eval", 1900, 4900, 9, True, True),
        _span(12, "gram.certify.eval", 4900, 7900, 9, True, True),
        _span(13, "host.inside.host", 5000, 6000, 12, True, True),
    ]


def _sscn_log(steps=4):
    log, t = [], 0
    for i in range(steps):
        step = _span(len(log), "sscn.step", t, t + 60,
                     counts={"sscn_step.block_replays": int(i == 1)})
        log.append(step)
        log.append(_span(len(log), "sscn.draw", t, t + 30 + i, step.id,
                         True, True))
        t += 60
    return log


@pytest.fixture
def log(monkeypatch):
    recs = []
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    return recs


def test_gram_readers_sum_their_spans(log):
    log.extend(_gram_log())
    ctx = _ctx(busy_s=1.0, window_s=10.0)
    assert _read("init_state_s.gram", ctx) == pytest.approx(0.5)
    assert _read("reinject_s.gram", ctx) == pytest.approx(0.5)
    assert _read("certify_eval_s.gram", ctx) == pytest.approx(6.0)
    # idle 9 s; named: init_state 0.5, pack 0.1, two reinjections 0.4
    # (the rollback opened with work queued), two evaluations 6.0 (the
    # host span inside one counted once): 7.0 s
    assert _read("idle_unnamed.gram", ctx) == pytest.approx(20.0)


def test_sscn_readers_average_their_spans(log):
    log.extend(_sscn_log(4))
    ctx = _ctx(busy_s=0.1, window_s=0.24)
    assert _read("draw_ms.sscn", ctx) == pytest.approx(31.5)
    assert _read("blocks_per_step.sscn", ctx) == pytest.approx(0.25)
    # idle 0.14 s, named 0.126 s
    assert _read("idle_unnamed.sscn", ctx) == pytest.approx(
        100 * (0.14 - 0.126) / 0.24)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_log_reads_nothing(log, name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "krylov_crn_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["krylov_crn_tpu_torch.utils"], "spans")
    assert _read(name, _ctx()) is None


def test_the_idle_share_needs_a_profile(log):
    log.extend(_gram_log())
    assert _read("idle_unnamed.gram", types.SimpleNamespace(
        profile=None)) is None


@pytest.mark.parametrize("workload, names", [
    ("rcv1.gram_krylov", ("init_state_s.gram", "reinject_s.gram",
                          "certify_eval_s.gram")),
    ("news20.sscn_m1000", ("draw_ms.sscn", "blocks_per_step.sscn"))])
def test_the_readers_find_the_spans_of_a_run(tiny_root, workload, names):
    """A CPU run of the cell with spans on: each reader of the cell finds
    what the program logged, and reads a finite number."""
    cell = harness.load_cell(workload, tiny_root)
    assert set(names) <= {m["name"] for m in cell["per_layer"]}
    spans.clear()
    spans.enable()
    try:
        harness.run(workload, 5, 0.1, False, root=tiny_root, device="cpu")
        for name in names:
            value = _read(name, _ctx())
            assert value is not None and value >= 0, name
            assert value == value and value < float("inf"), name
    finally:
        spans.disable()
        spans.clear()
