"""``folds_per_step.gram`` on hand-made span logs: the fold launches that
the traced solve's ``gram.replay`` spans counted, over their replays; a
program whose replay spans count no folds (or that has no spans) reads
nothing."""

import sys
import types
from pathlib import Path

import pytest

from benchmark import harness
from krylov_crn_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[2]
NAME = "folds_per_step.gram"
MS = 1_000_000  # ns


def _read(ctx=None):
    return harness.load_module(
        REPO / "benchmark" / "metrics" / f"{NAME}.py").read(
            ctx or types.SimpleNamespace(profile=None, solves=[]))


def _span(id, name, start_ms, end_ms, counts=None):
    rec = spans.Span(id, None, name, start_ms * MS, False, None)
    rec.end_ns = end_ms * MS
    rec.counts = counts or {}
    return rec


def _replays(log, chunks, folds=24):
    """Chunks of ``chunks`` replays each, a fetch after each."""
    for k in chunks:
        t = 100 * len(log)
        counts = {"gram_krylov_step.graph_replays": k}
        if folds is not None:
            counts["fold.launches"] = folds * k
        log.append(_span(len(log), "gram.replay", t, t + 50, counts))
        log.append(_span(len(log), "gram.fetch", t + 50, t + 60))


@pytest.fixture
def log(monkeypatch):
    recs = []
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    return recs


def test_the_launches_over_the_replays(log):
    _replays(log, [24, 12, 1])
    assert _read() == pytest.approx(24.0)
    log.append(_span(len(log), "gram.replay", 9000, 9050,
                     {"fold.launches": 0,
                      "gram_krylov_step.graph_replays": 0}))
    assert _read() == pytest.approx(24.0)


def test_uneven_chunks_weigh_by_their_replays(log):
    _replays(log, [3], folds=24)
    _replays(log, [1], folds=28)
    assert _read() == pytest.approx((3 * 24 + 28) / 4)


@pytest.mark.parametrize("folds", [None, "empty"])
def test_replay_spans_without_fold_counts_read_nothing(log, folds):
    if folds is None:  # the spans of a program without the fold counter
        _replays(log, [24, 12], folds=None)
    assert _read() is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "krylov_crn_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["krylov_crn_tpu_torch.utils"], "spans")
    assert _read() is None
