"""A Gram Krylov chunk without host round trips: ``gram_krylov_step`` reads
nothing back to the host outside its subproblem call (on a card, the
subproblem kernel), and ``GramKrylov.run_fused`` replays captured steps
(``krylov_gram._StepGraphs``) whose chunks equal the eager chunks.

On the CPU the capture is stood in for by the step's own Python body,
called at every replay (the CPU has no CUDA graphs): that holds the
graphs' bookkeeping (static state, row stacks at a device-side index,
keys, rollbacks, the bf16 head's two phases) to the eager run bit for bit.
The process keeps a card's graphs by the step's shape
(``krylov_gram._GraphCache``): solvers of one shape on other data replay
one graph, which reads their K through a slot and their small arrays from
static copies, each run bit for bit its eager run; each part of the key
misses; the bf16 head and a mesh keep off the cache; the cache is bounded
and keeps no K alive. The tests marked ``cuda`` capture and replay on the
card."""

import gc
import types
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
from krylov_crn_tpu_torch.solvers import krylov_gram as tk
from krylov_crn_tpu_torch.utils import spans
from krylov_crn_tpu_torch.utils.graphs import StepGraphs

CPU = "cpu"  # the library's default device is the card
HOST_READS = ("__bool__", "item", "__float__", "__int__", "tolist", "numpy")
REPO = Path(__file__).resolve().parents[1]


def _problem(seed, n=400, d=60):
    """The suite's n x d problem (tests/conftest.py, seed 7), made here:
    the card's machine runs this file's cuda tests without the conftest."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return sp.csr_matrix(Ad), b, np.ones(d) * 0.5


@pytest.fixture(scope="module")
def small_problem():
    return _problem(7)


def _solver(small_problem, dtype=np.float32, l2=0.0, head=False,
            device=CPU, reg_coef=1e-3, m=10):
    A, b, x0 = small_problem
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=dtype, l2=l2,
                                             device=device),
                     reg_coef=reg_coef, subspace_dim=m, tolerance=0,
                     bf16_head=head, device=device)
    return alg, x0


def _eager(alg):
    """``alg`` with run_fused's eager path, whatever graphs the test has."""
    alg._step_graphs = lambda: None
    return alg


@pytest.mark.parametrize("l2, head", [(0.0, False), (1e-2, False),
                                      (0.0, True)])
def test_step_makes_no_host_read_outside_the_subproblem(small_problem,
                                                        monkeypatch, l2,
                                                        head):
    alg, x0 = _solver(small_problem, l2=l2, head=head)
    alg.init_run(x0, 42)
    kw = alg._step_kwargs()
    banned = {"on": True}

    def refuse(name, real):
        def read(self, *a, **k):
            if banned["on"]:
                raise AssertionError(f"host read through Tensor.{name}")
            return real(self, *a, **k)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(name, getattr(torch.Tensor, name)))
    plain = tk.tridiag_secular
    calls = []

    def subproblem(*args, **kw):  # the CPU's plain Newton reads its flag
        banned["on"] = False
        try:
            calls.append(1)
            return plain(*args, **kw)
        finally:
            banned["on"] = True

    monkeypatch.setattr(tk, "tridiag_secular", subproblem)
    state = alg.state
    try:
        for _ in range(3):
            state = tk.gram_krylov_step(alg.gd, state, use_lr=head, **kw)
    finally:
        banned["on"] = False
    assert len(calls) == 3
    assert np.isfinite(float(state.value))


class _OnACard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's would."""

    @property
    def is_cuda(self):
        return True


def _graphs_on_the_cpu(monkeypatch):
    """Replays that call the captured body itself, and run_fused taking
    the graphs' path on the CPU: ``GramKrylov._step_graphs`` itself, asked
    with a state that answers as a card's would."""
    step_graphs = tk.GramKrylov._step_graphs

    def on_a_card(self):
        state = self.state
        self.state = state._replace(zeta=state.zeta.as_subclass(_OnACard))
        try:
            return step_graphs(self)
        finally:
            self.state = state

    monkeypatch.setattr(tk.GramKrylov, "_step_graphs", on_a_card)
    monkeypatch.setattr(StepGraphs, "_on_capture_stream",
                        lambda self, fn: fn())
    monkeypatch.setattr(StepGraphs, "_record",
                        lambda self, body: types.SimpleNamespace(
                            replay=body))


@pytest.fixture
def empty_cache():
    """The process's graph cache, empty at the start and at the end."""
    tk._clear_graph_caches()
    yield
    tk._clear_graph_caches()


@pytest.fixture
def cpu_graphs(monkeypatch, empty_cache):
    """The CPU stand-in, from an empty cache; its graph cache."""
    _graphs_on_the_cpu(monkeypatch)
    return tk._graph_cache(torch.device(CPU))


def _captures():
    return tk.gram_krylov_step.graph_captures


def _same_run(a, b, ta, tb):
    assert list(ta.its) == list(tb.its)
    np.testing.assert_array_equal(np.asarray(ta.loss_vals),
                                  np.asarray(tb.loss_vals))
    for key in ("exact_its", "exact_fs", "boundary_fs", "rollback_its",
                "grad_norm", "diff_norm"):
        assert list(ta.metrics[key]) == list(tb.metrics[key]), key
    assert ta.solver_its == tb.solver_its
    for f in tk.GramKrylovState._fields:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("head", [False, True])
def test_replayed_run_equals_eager_run(small_problem, monkeypatch,
                                       empty_cache, head):
    """fp32, certified, chunk 8 for 40 iterations (rollbacks, retries of
    one iteration and the short last chunk included): the replayed run
    and the eager run agree bit for bit, a replay per iteration run, and
    every graph captured in ``warm_fused``: one on the cache's path, both
    use_lr phases on the bf16 head's."""
    eager, x0 = _solver(small_problem, head=head)
    te = eager.run_fused(x0, it_max=40, chunk=8, certify=True)

    _graphs_on_the_cpu(monkeypatch)
    alg, _ = _solver(small_problem, head=head)
    alg.init_run(x0, 42)
    alg.initialized = True
    c0 = tk.gram_krylov_step.graph_captures
    alg.warm_fused(chunk=8, certify=True)
    captured = tk.gram_krylov_step.graph_captures - c0
    assert captured == (2 if head else 1)  # both use_lr phases
    r0 = tk.gram_krylov_step.graph_replays
    tr = alg.run_fused(x0, it_max=40, chunk=8, certify=True)
    assert tk.gram_krylov_step.graph_captures - c0 == captured
    retries = len(tr.metrics["rollback_its"])
    assert tk.gram_krylov_step.graph_replays - r0 >= alg.it + retries
    _same_run(alg, eager, tr, te)
    if head:
        assert not alg._use_lr  # the switch to the fp32 K happened


def test_graphs_follow_their_keys(small_problem, cpu_graphs):
    """One capture per key, and none for a new K of the same shape: a
    second run_fused on the instance builds a new K and replays the graph
    the first captured; other step arguments capture a graph beside it; a
    run replays what ``warm_fused`` captured."""
    alg, x0 = _solver(small_problem, dtype=np.float64)
    c0 = _captures()
    alg.run_fused(x0, it_max=6, chunk=3)
    K = alg.gd.K
    assert _captures() - c0 == 1 and len(cpu_graphs.members) == 1
    alg.run_fused(x0, it_max=6, chunk=3)
    assert alg.gd.K is not K and len(cpu_graphs.members) == 1
    assert _captures() - c0 == 1
    alg.init_run(x0, 42)
    alg.initialized = True
    alg.warm_fused(chunk=3)
    alg.ls_max = 10
    alg.warm_fused(chunk=3)
    assert len(cpu_graphs.members) == 2
    assert _captures() - c0 == 2
    alg.run_fused(x0, it_max=3, chunk=3)
    assert _captures() - c0 == 2


def _same_chunk(a, b):
    (sa, oa), (sb, ob) = a, b
    for f in tk.GramKrylovState._fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    flat = lambda o: [o[0][0], o[0][1], *o[1:4], *o[4]]
    for x, y in zip(flat(oa), flat(ob)):
        assert torch.equal(x, y)


# a step's compensated folds at m = 10: Lanczos's 20 rep_dots, the
# gradient's and the step's norms, the candidates' dot2 and sum2
FOLDS_PER_STEP = 24


def _replay_spans(graphs, solver, chunks=2):
    """The ``gram.replay`` spans of ``chunks`` chunks of 8 of ``solver``
    through ``graphs``."""
    spans.clear()
    spans.enable()
    try:
        _chunks(graphs, [solver], chunks)
    finally:
        spans.disable()
    recs = [r for r in spans.records() if r.name == "gram.replay"]
    spans.clear()
    return recs


def test_a_replay_span_counts_its_steps_folds(small_problem, cpu_graphs,
                                             monkeypatch):
    """A chunk's ``gram.replay`` span counts its replays and the fold
    launches they add (what ``folds_per_step.gram`` reads): 24 a step. The
    CPU stands in for the kernel by counting each plain fold as one."""
    from krylov_crn_tpu_torch.ops import math as tm

    lane_fold = tm._lane_fold

    def counted(*args, **kw):
        tm.fold.launches += 1
        return lane_fold(*args, **kw)

    monkeypatch.setattr(tm, "_lane_fold", counted)
    recs = _replay_spans(cpu_graphs, _solver(small_problem))
    assert [r.counts for r in recs] == [
        {"fold.launches": 8 * FOLDS_PER_STEP,
         "gram_krylov_step.graph_replays": 8}] * 2


@pytest.mark.parametrize("order", ["back_to_back", "interleaved"])
@pytest.mark.parametrize("solvers", [2, 3])
def test_solvers_of_one_shape_share_one_graph(cpu_graphs, solvers, order):
    """fp32 solvers on other data of one shape (400 x 60, seeds 11 on):
    back to back, each certified run_fused of 24 iterations in chunks of 8
    equals its eager run bit for bit; interleaved chunk by chunk through
    the cache, each chunk equals the eager chunk from the same state. One
    capture in all: the graph reads each chunk's own K and small arrays."""
    problems = [_problem(seed) for seed in range(11, 11 + solvers)]
    c0 = _captures()
    if order == "back_to_back":
        for p in problems:
            eager, x0 = _solver(p)
            te = _eager(eager).run_fused(x0, it_max=24, chunk=8,
                                         certify=True)
            alg, _ = _solver(p)
            tr = alg.run_fused(x0, it_max=24, chunk=8, certify=True)
            _same_run(alg, eager, tr, te)
    else:
        algs = [_solver(p)[0] for p in problems]
        for alg, p in zip(algs, problems):
            alg.init_run(p[2], 42)
        kws = [alg._step_kwargs() for alg in algs]
        graphs = [alg._step_graphs() for alg in algs]
        assert all(g is cpu_graphs for g in graphs)
        states = [alg.state for alg in algs]
        for _ in range(3):
            for i, alg in enumerate(algs):
                entry = cpu_graphs.graph(alg.gd, states[i], kws[i], False,
                                         True, 8)
                replayed = cpu_graphs.run(entry, states[i], 8, True)
                eager = tk.gram_krylov_multistep(
                    alg.gd, states[i], chunk=8, stack_reps=True,
                    use_lr=False, **kws[i])
                _same_chunk(replayed, eager)
                states[i] = replayed[0]
    assert _captures() - c0 == 1
    assert len(cpu_graphs.members) == 1


# one part of the key changed against the base (fp32, m 10, reg_coef 1e-3,
# certified, chunk 8, the 400 x 60 problem)
MISSES = {
    "n": dict(rows=399),  # the same n_pad, 512
    "dtype": dict(dtype=np.float64),
    "m": dict(m=8),
    "reg_ceil": dict(reg_coef=500.0),  # max(1e6, 1e4 reg_coef)
    "stack_reps": dict(certify=False),
    "chunk": dict(chunk=16),  # more rows than the stacks hold
}


@pytest.mark.parametrize("part", sorted(MISSES))
def test_each_part_of_the_key_misses(cpu_graphs, part):
    """A solver on other data of the base's shape reuses the base's graph;
    one that differs in one part of the key captures a graph of its own."""
    def warm(seed, rows=400, dtype=np.float32, m=10, reg_coef=1e-3,
             certify=True, chunk=8):
        alg, x0 = _solver(_problem(seed, n=rows), dtype=dtype,
                          reg_coef=reg_coef, m=m)
        alg.init_run(x0, 42)
        alg.warm_fused(chunk=chunk, certify=certify)
        return alg.gd.n_padded

    c0 = _captures()
    n_pad = warm(7)
    assert warm(8) == n_pad and _captures() - c0 == 1
    assert warm(9, **MISSES[part]) == n_pad
    assert _captures() - c0 == 2 and len(cpu_graphs.members) == 2


@pytest.mark.parametrize("path", ["K_lr", "mesh"])
def test_per_instance_paths_keep_off_the_cache(small_problem, cpu_graphs,
                                               monkeypatch, path):
    """A GramData with a bf16 K_lr keeps per-instance graphs, captured
    anew for each solver; a solver under a mesh of several ranks runs
    eagerly (here a stand-in mesh whose replicated-state check passes),
    its run the eager run's bits. Neither touches the cache."""
    c0 = _captures()
    if path == "K_lr":
        for seed in (11, 12):
            alg, x0 = _solver(_problem(seed), head=True)
            alg.init_run(x0, 42)
            alg.warm_fused(chunk=8, certify=True)
            assert alg._step_graphs() is alg._graphs
        assert _captures() - c0 == 4  # both use_lr phases, each solver
    else:
        monkeypatch.setattr(tk, "check_replicated", lambda *a, **k: None)
        eager, x0 = _solver(small_problem)
        te = _eager(eager).run_fused(x0, it_max=16, chunk=8, certify=True)
        alg, _ = _solver(small_problem)
        alg.init_run(x0, 42)
        alg.initialized = True
        alg.mesh = types.SimpleNamespace(distributed=True)
        assert alg._step_graphs() is None
        alg.warm_fused(chunk=8, certify=True)
        tr = alg.run_fused(x0, it_max=16, chunk=8, certify=True)
        _same_run(alg, eager, tr, te)
        assert _captures() == c0
    assert not cpu_graphs.members


def test_the_cache_is_bounded(small_problem, cpu_graphs):
    """CACHE_SIZE graphs a card: the one asked for least recently goes
    first, and is captured anew when asked for again."""
    alg, x0 = _solver(small_problem)
    alg.init_run(x0, 42)
    c0 = _captures()
    sizes = range(10, 11 + tk.CACHE_SIZE)
    for ls_max in sizes:
        alg.ls_max = ls_max
        alg.warm_fused(chunk=4)
    assert _captures() - c0 == len(sizes)
    assert len(cpu_graphs.members) == tk.CACHE_SIZE
    alg.warm_fused(chunk=4)  # the newest
    assert _captures() - c0 == len(sizes)
    alg.ls_max = sizes[0]  # dropped
    alg.warm_fused(chunk=4)
    assert _captures() - c0 == len(sizes) + 1
    assert len(cpu_graphs.members) == tk.CACHE_SIZE


def test_the_cache_keeps_no_K_alive(small_problem, cpu_graphs):
    """A deleted solver's K is freed: the cached graph holds its address
    in the slot and copies of its small arrays, never the GramData."""
    alg, x0 = _solver(small_problem)
    alg.run_fused(x0, it_max=8, chunk=4, certify=True)
    K, Ax0 = weakref.ref(alg.gd.K), weakref.ref(alg.gd.Ax0)
    del alg
    gc.collect()
    assert K() is None and Ax0() is None
    assert len(cpu_graphs.members) == 1


def test_warm_fused_counts_what_it_reused(small_problem, cpu_graphs):
    """``gram.warm_fused`` counts the graphs it captured and those it
    reused, and the benchmark's ``graph_reuse.gram`` reads the share
    reused: 0% for the first solver of a shape, 100% for the next; nothing
    from a span that counts no reuse."""
    from benchmark import harness

    reader = harness.load_module(REPO / "benchmark" / "metrics"
                                 / "graph_reuse.gram.py")
    readings, counts = [], []
    try:
        for _ in range(2):
            alg, x0 = _solver(small_problem)
            alg.init_run(x0, 42)
            spans.clear()
            spans.enable()
            alg.warm_fused(chunk=8, certify=True)
            spans.disable()
            readings.append(reader.read(None))
            counts += [r.counts for r in spans.records()
                       if r.name == "gram.warm_fused"]
        spans.clear()
        uncounted = spans.Span(0, None, "gram.warm_fused", 0, False, None)
        uncounted.end_ns = 1
        spans._log.append(uncounted)
        readings.append(reader.read(None))
    finally:
        spans.disable()
        spans.clear()
    assert counts == [{"gram_krylov_step.graph_captures": 1,
                       "gram_krylov_step.graph_reuses": 0},
                      {"gram_krylov_step.graph_captures": 0,
                       "gram_krylov_step.graph_reuses": 1}]
    assert readings == [0.0, 100.0, None]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_chunk_equals_eager_chunk_on_card(small_problem,
                                                   cuda_device, empty_cache):
    """One captured step replayed for a chunk of 8 from the initial state,
    inside sync debug mode "error", against 8 eager steps: the same bits,
    and the kernels' counts added per replay, through the card's cache (K
    read through the slot). The instance's graphs, which serve a GramData
    with a K_lr, are held to eager runs by
    ``test_replayed_run_equals_eager_run[head=True]``."""
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.subproblem import tridiag_secular
    from krylov_crn_tpu_torch.ops.symv import symv

    alg, x0 = _solver(small_problem, device=cuda_device)
    alg.init_run(x0, 42)
    kw = alg._step_kwargs()
    st0 = alg.state
    eager, outs = tk.gram_krylov_multistep(alg.gd, st0, chunk=8,
                                           stack_reps=True, use_lr=False,
                                           **kw)
    graphs = tk._graph_cache(cuda_device)
    entry = graphs.graph(alg.gd, st0, kw, False, True, 8)
    s0, c0, t0 = symv.launches, k_matvec.cuda_calls, tridiag_secular.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed, routs = graphs.run(entry, st0, 8, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert symv.launches - s0 == k_matvec.cuda_calls - c0 == 8 * 11
    assert tridiag_secular.launches - t0 == 8
    for f in tk.GramKrylovState._fields:
        assert torch.equal(getattr(replayed, f), getattr(eager, f)), f
    flat = lambda o: [o[0][0], o[0][1], *o[1:4], *o[4]]
    for a, b in zip(flat(routs), flat(outs)):
        assert torch.equal(a, b)


def _race(problem, device, it_max=24):
    alg, x0 = _solver(problem, device=device)
    alg.init_run(x0, 42)
    alg.initialized = True
    alg.warm_fused(chunk=8, certify=True)
    return alg, alg.run_fused(x0, it_max=it_max, chunk=8, certify=True)


def _chunks(graphs, solvers, chunks=3):
    """``chunks`` chunks of 8 of each (solver, x0) in ``solvers``,
    interleaved through ``graphs``; each solver's chunks, as (state,
    stacks)."""
    algs = [alg for alg, _ in solvers]
    for alg, x0 in solvers:
        alg.init_run(x0, 42)
    states = [alg.state for alg in algs]
    kws = [alg._step_kwargs() for alg in algs]
    got = [[] for _ in algs]
    for _ in range(chunks):
        for i, alg in enumerate(algs):
            entry = graphs.graph(alg.gd, states[i], kws[i], False, True, 8)
            got[i].append(graphs.run(entry, states[i], 8, True))
            states[i] = got[i][-1][0]
    return got


@pytest.mark.cuda
def test_solvers_of_one_shape_replay_one_graph_on_card(cuda_device,
                                                       empty_cache):
    """Three solvers on three seeds' data of one shape: back to back (a
    certified run_fused each) and interleaved chunk by chunk through the
    cache, they give the bits of their runs on a cleared cache, and
    ``graph_captures`` rises by exactly 1 for each way."""
    problems = [_problem(seed) for seed in (21, 22, 23)]
    alone = []
    for p in problems:
        tk._clear_graph_caches()
        alone.append(_race(p, cuda_device))
    tk._clear_graph_caches()
    c0 = _captures()
    for p, (a_alg, a_tr) in zip(problems, alone):
        alg, tr = _race(p, cuda_device)
        _same_run(alg, a_alg, tr, a_tr)
    assert _captures() - c0 == 1

    cache = tk._graph_cache(cuda_device)
    solvers = lambda: [_solver(p, device=cuda_device) for p in problems]
    single = []
    for solver in solvers():
        tk._clear_graph_caches()
        single += _chunks(cache, [solver])
    tk._clear_graph_caches()
    c0 = _captures()
    mixed = _chunks(cache, solvers())
    assert _captures() - c0 == 1
    for got, want in zip(mixed, single):
        for a, b in zip(got, want):
            _same_chunk(a, b)


@pytest.mark.cuda
def test_a_replay_span_counts_its_steps_folds_on_card(small_problem,
                                                     cuda_device,
                                                     empty_cache):
    """On the card each of a step's folds is one launch of csrc/fold.cu,
    which a replay adds from its capture: 24 a replayed step on the
    chunk's ``gram.replay`` span."""
    recs = _replay_spans(tk._graph_cache(cuda_device),
                         _solver(small_problem, device=cuda_device))
    assert [r.counts for r in recs] == [
        {"fold.launches": 8 * FOLDS_PER_STEP,
         "gram_krylov_step.graph_replays": 8}] * 2


@pytest.mark.cuda
def test_a_deleted_solver_frees_its_K_on_card(small_problem, cuda_device,
                                              empty_cache):
    """The cached graph keeps no K: deleting the solver that ran it gives
    back at least K's bytes."""
    alg, _ = _race(small_problem, cuda_device, it_max=8)
    k_bytes = alg.gd.K.numel() * alg.gd.K.element_size()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    del alg
    gc.collect()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated(cuda_device) >= k_bytes
    assert len(tk._graph_cache(cuda_device).members) == 1


@pytest.mark.cuda
def test_one_capture_stream_a_card(small_problem, cuda_device, empty_cache,
                                   monkeypatch):
    """A second solver of the same shape captures nothing, so makes no
    stream; a solver of another key captures on the card's one stream
    (the port makes streams only in ``StepGraphs._on_capture_stream``,
    where the graphs have none yet)."""
    _race(small_problem, cuda_device, it_max=8)
    cache = tk._graph_cache(cuda_device)
    first = cache.stream
    assert first is not None
    new_stream = []
    on_stream = StepGraphs._on_capture_stream

    def watched(self, fn):
        new_stream.append(self.stream is None)
        return on_stream(self, fn)

    monkeypatch.setattr(StepGraphs, "_on_capture_stream", watched)
    c0 = _captures()
    _race(small_problem, cuda_device, it_max=8)
    assert new_stream == [] and _captures() == c0
    alg, x0 = _solver(small_problem, device=cuda_device, m=8)
    alg.init_run(x0, 42)
    alg.warm_fused(chunk=8, certify=True)
    assert new_stream == [False] and _captures() - c0 == 1
    assert cache.stream is first
    assert all(g.stream is first for g in cache.members.values())
