"""The span recorder (``utils/spans``) and the spans the solvers open.

Off, a span is one shared object that does nothing; on (``enable()``, or
while a torch profiler is active) it logs its parent, its times on the
profiler's clock, whether the card had drained at a host span's entry,
and what the counters it names counted. A CPU GramKrylov run and an SSCN
run open the spans where their host work happens, a d-space CubicKrylov
run one span a step, and a run with spans on has the bits of a run with
spans off. The test marked ``cuda`` opens host spans around a graph
capture on the card."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import (
    SSCN,
    CubicKrylov,
    GramKrylov,
    LogisticRegression,
)
from krylov_crn_tpu_torch.utils import spans

CPU = "cpu"  # the library's default device is the card


@pytest.fixture(autouse=True)
def fresh_log():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


@pytest.fixture(scope="module")
def small_problem():
    """The suite's 400 x 60 problem (tests/conftest.py), made here: the
    card's machine runs this file's cuda test without the conftest."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    n, d = 400, 60
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return sp.csr_matrix(Ad), b, np.ones(d) * 0.5


def _names(recs):
    return [r.name for r in recs]


def test_off_spans_are_one_shared_no_op():
    a = spans.span("a", host=True)
    b = spans.span("b", counts=((test_off_spans_are_one_shared_no_op,
                                 "__name__"),))
    assert a is b
    with a as rec:
        assert rec is None
    assert spans.records() == [] and spans.dropped() == 0


def _counter():
    pass


_counter.calls = 0


def test_on_spans_nest_time_and_count():
    spans.enable()
    with spans.span("outer", counts=((_counter, "calls"),)) as outer:
        _counter.calls += 2
        with spans.span("inner", host=True) as inner:
            _counter.calls += 1
            sum(range(20000))
        with spans.span("second"):
            pass
    with spans.span("after"):
        pass
    recs = spans.records()
    assert _names(recs) == ["outer", "inner", "second", "after"]
    by = {r.name: r for r in recs}
    assert by["outer"] is outer and by["inner"] is inner
    assert outer.parent is None and by["after"].parent is None
    assert inner.parent == by["second"].parent == outer.id
    assert len({r.id for r in recs}) == 4
    assert outer.counts == {"_counter.calls": 3}
    assert inner.counts == {}
    assert inner.host and not outer.host
    # no card here: no stream to ask whether it drained
    assert inner.drained is None
    assert outer.start_ns <= inner.start_ns < inner.end_ns
    assert inner.end_ns <= by["second"].start_ns <= by["second"].end_ns
    assert by["second"].end_ns <= outer.end_ns <= by["after"].start_ns
    assert inner.seconds > 0 and outer.seconds >= inner.seconds
    spans.disable()
    with spans.span("off"):
        pass
    assert len(spans.records()) == 4


def test_the_log_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)
    spans.enable()
    for i in range(5):
        with spans.span(f"s{i}"):
            pass
    assert _names(spans.records()) == ["s0", "s1", "s2"]
    assert spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_an_active_profiler_turns_spans_on_on_its_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with spans.span(f"p{i}"):
                with spans.span(f"p{i}.child", host=True):
                    sum(range(10000))
    with spans.span("after"):
        pass
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"p0", "p1", "p2", "p0.child", "p1.child",
                         "p2.child"}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("krylov::")]
    assert len(events) == 6
    for e in events:
        rec = recs[e.name()[len("krylov::"):]]
        assert abs(e.start_ns() - rec.start_ns) < 1_000_000, (e.name(),)
        assert abs(e.end_ns() - rec.end_ns) < 1_000_000, (e.name(),)


def _gram(small_problem):
    A, b, x0 = small_problem
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                             device=CPU),
                     reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=CPU)
    alg.init_run(x0, 42)
    alg.initialized = True
    trace = alg.run_fused(x0, it_max=4, chunk=2, certify=True)
    return alg, trace


def test_a_gram_run_opens_its_spans_and_keeps_its_bits(small_problem):
    off_alg, off = _gram(small_problem)
    assert spans.records() == []
    spans.enable()
    alg, on = _gram(small_problem)
    recs = spans.records()
    names = _names(recs)
    m = on.metrics
    chunks = len(m["boundary_its"]) + len(m["rollback_its"])
    assert chunks >= 2
    assert names.count("gram.init_run") == 1
    assert names.count("gram.init_state") == 1
    assert names.count("gram.build_K") == 1
    assert names.count("gram.exact_setup") == 1
    assert names.count("gram.run_fused") == 1
    assert names.count("gram.fetch") == chunks
    assert names.count("gram.reinject") == chunks
    assert names.count("gram.rollback") == len(m["rollback_its"])
    assert names.count("gram.certify") == 1
    assert names.count("gram.certify.fetch") == len(m["boundary_its"])
    assert names.count("gram.certify.eval") == len(m["boundary_its"])
    by_id = {r.id: r for r in recs}
    parent = lambda r: by_id[r.parent].name if r.parent is not None else None
    for r in recs:
        want = {"gram.init_state": "gram.init_run",
                "gram.build_K": "gram.init_run",
                "gram.exact_setup": "gram.run_fused",
                "gram.fetch": "gram.run_fused",
                "gram.reinject": "gram.run_fused",
                "gram.certify": "gram.run_fused",
                "gram.certify.eval": "gram.certify"}.get(r.name)
        if want is not None:
            assert parent(r) == want, r
    host = {r.name for r in recs if r.host}
    assert host == {"gram.init_state", "gram.exact_setup", "gram.reinject",
                    "gram.certify.eval"}
    # the same bits with spans on as off
    np.testing.assert_array_equal(on.loss_vals, off.loss_vals)
    assert on.its == off.its
    for key in ("exact_its", "exact_fs", "boundary_fs", "grad_norm",
                "diff_norm", "rollback_its"):
        np.testing.assert_array_equal(np.asarray(m[key]),
                                      np.asarray(off.metrics[key]))
    for f in alg.state._fields:
        assert torch.equal(getattr(alg.state, f),
                           getattr(off_alg.state, f)), f


def test_an_sscn_run_draws_inside_its_steps(small_problem):
    A, b, x0 = small_problem
    alg = SSCN(loss=LogisticRegression(A, b, dtype=np.float32, device=CPU),
               reg_coef=1e-3, subspace_dim=12, tolerance=0)
    spans.enable()
    alg.run(x0, it_max=5)
    recs = spans.records()
    by_id = {r.id: r for r in recs}
    draws = [r for r in recs if r.name == "sscn.draw"]
    steps = [r for r in recs if r.name == "sscn.step"]
    assert len(draws) == len(steps) == 5
    assert all(d.host and by_id[d.parent].name == "sscn.step"
               for d in draws)
    # a flag read a block: the first block's and the further ones'
    reads = [r for r in recs if r.name == "search.read"]
    assert len(reads) == 5 + sum(alg.trace.metrics["ls_blocks"])
    assert all(by_id[r.parent].name == "sscn.step" for r in reads)
    # eager on the CPU: no further-block graph replayed
    assert all(s.counts == {"sscn_step.block_replays": 0} for s in steps)
    assert _names(recs).count("run.checkpoint") == 5


def _krylov(small_problem, steps):
    """A CubicKrylov run on the dense branch (d = 60 <= 2048, as w8a)."""
    A, b, x0 = small_problem
    alg = CubicKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                              device=CPU),
                      reg_coef=1e-3, subspace_dim=10, tolerance=0)
    assert alg.loss.data.dense is not None
    return alg, alg.run(x0, it_max=steps)


def test_a_dspace_run_opens_a_span_a_step_and_keeps_its_bits(small_problem):
    off_alg, off = _krylov(small_problem, 5)
    assert spans.records() == []
    spans.enable()
    alg, on = _krylov(small_problem, 5)
    recs = spans.records()
    init = [r for r in recs if r.name == "krylov.init_state"]
    steps = [r for r in recs if r.name == "krylov.step"]
    assert len(init) == 1 and len(steps) == 5
    # the state at x0 before every step; neither opens inside another span
    # or is a host span
    assert all(init[0].end_ns <= s.start_ns for s in steps)
    assert all(r.parent is None and not r.host for r in init + steps)
    # eager on the CPU: the counter is there, and counts nothing
    assert all(s.counts == {"matvec.launches": 0} for s in steps)
    # the same bits with spans on as off
    assert on.its == off.its
    for x_on, x_off in zip(on.xs[1:], off.xs[1:]):
        assert torch.equal(x_on, x_off)
    for f in alg.state._fields:
        assert torch.equal(getattr(alg.state, f),
                           getattr(off_alg.state, f)), f


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_host_spans_around_a_capture_on_the_card(small_problem, cuda_device,
                                                 monkeypatch):
    """A host span inside a capture asks the stream nothing, and the
    capture replays right; a Gram run on the card with spans on has the
    bits of one with spans off and opens its capture and replay spans
    (each run from an empty graph cache, so that each captures)."""
    from krylov_crn_tpu_torch.solvers import krylov_gram as kg

    asked = []
    query = torch.cuda.Stream.query

    def watched(self):
        asked.append(torch.cuda.is_current_stream_capturing())
        return query(self)

    monkeypatch.setattr(torch.cuda.Stream, "query", watched)
    spans.enable()
    x = torch.arange(4096, dtype=torch.float32, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2.0 + 1.0
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with spans.span("before", host=True):
        with torch.cuda.graph(graph):
            with spans.span("inside", host=True):
                y = x * 2.0 + 1.0
    x.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2.0 + 1.0)
    recs = {r.name: r for r in spans.records()}
    assert recs["inside"].drained is None
    assert isinstance(recs["before"].drained, bool)
    assert asked == [False]

    spans.disable()
    spans.clear()
    A, b, x0 = small_problem

    def race():
        # each race captures: the process's graphs of this shape dropped
        kg._clear_graph_caches()
        alg = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                                 device=cuda_device),
                         reg_coef=1e-3, subspace_dim=10, tolerance=0,
                         device=cuda_device)
        alg.init_run(x0, 42)
        alg.initialized = True
        alg.warm_fused(chunk=4, certify=True)
        return alg.run_fused(x0, it_max=8, chunk=4, certify=True)

    off = race()
    spans.enable()
    on = race()
    np.testing.assert_array_equal(on.loss_vals, off.loss_vals)
    names = _names(spans.records())
    for name in ("graphs.capture", "graphs.record", "gram.replay",
                 "gram.build_K.pack", "gram.warm_fused"):
        assert name in names, name
    assert all(asked_while is False for asked_while in asked)
