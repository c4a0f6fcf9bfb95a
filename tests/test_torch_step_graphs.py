"""A Gram Krylov chunk without host round trips: ``gram_krylov_step`` reads
nothing back to the host outside its subproblem call (on a card, the
subproblem kernel), and ``GramKrylov.run_fused`` replays captured steps
(``krylov_gram._StepGraphs``) whose chunks equal the eager chunks.

On the CPU the capture is stood in for by the step's own Python body,
called at every replay (the CPU has no CUDA graphs): that holds the
graphs' bookkeeping (static state, row stacks at a device-side index,
keys, rollbacks, the bf16 head's two phases) to the eager run bit for bit.
The tests marked ``cuda`` capture and replay on the card."""

import types

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
from krylov_crn_tpu_torch.solvers import krylov_gram as tk

CPU = "cpu"  # the library's default device is the card
HOST_READS = ("__bool__", "item", "__float__", "__int__", "tolist", "numpy")


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


def _solver(small_problem, dtype=np.float32, l2=0.0, head=False,
            device=CPU):
    A, b, x0 = small_problem
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=dtype, l2=l2,
                                             device=device),
                     reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     bf16_head=head, device=device)
    return alg, x0


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


def _graphs_on_the_cpu(monkeypatch):
    """Replays that call the captured body itself, and run_fused taking
    that path on the CPU."""
    def step_graphs(self):
        if self._graphs is None:
            self._graphs = tk._StepGraphs(self.state.zeta.device)
        return self._graphs

    monkeypatch.setattr(tk.GramKrylov, "_step_graphs", step_graphs)
    monkeypatch.setattr(tk._StepGraphs, "_on_capture_stream",
                        lambda self, fn: fn())
    monkeypatch.setattr(tk._StepGraphs, "_record",
                        lambda self, body: types.SimpleNamespace(
                            replay=body))


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
def test_replayed_run_equals_eager_run(small_problem, monkeypatch, head):
    """fp32, certified, chunk 8 for 40 iterations (rollbacks, retries of
    one iteration and the short last chunk included): the replayed run
    and the eager run agree bit for bit, a replay per iteration run, and
    every graph captured in ``warm_fused``."""
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


def test_graphs_follow_their_keys(small_problem, monkeypatch):
    """A run that builds a new K (a second run_fused on the instance)
    drops the old GramData's graphs and captures anew; other step
    arguments capture a graph beside the first; a run replays what
    ``warm_fused`` captured."""
    _graphs_on_the_cpu(monkeypatch)
    alg, x0 = _solver(small_problem, dtype=np.float64)
    c0 = tk.gram_krylov_step.graph_captures
    alg.run_fused(x0, it_max=6, chunk=3)
    graphs = alg._graphs
    assert tk.gram_krylov_step.graph_captures - c0 == 1
    alg.run_fused(x0, it_max=6, chunk=3)
    assert alg._graphs is graphs and len(graphs.graphs) == 1
    assert tk.gram_krylov_step.graph_captures - c0 == 2
    alg.init_run(x0, 42)
    alg.initialized = True
    alg.warm_fused(chunk=3)
    alg.ls_max = 10
    alg.warm_fused(chunk=3)
    assert len(graphs.graphs) == 2
    assert tk.gram_krylov_step.graph_captures - c0 == 4
    alg.run_fused(x0, it_max=3, chunk=3)
    assert tk.gram_krylov_step.graph_captures - c0 == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_chunk_equals_eager_chunk_on_card(small_problem,
                                                   cuda_device):
    """One captured step replayed for a chunk of 8 from the initial state,
    inside sync debug mode "error", against 8 eager steps: the same bits,
    and the kernels' counts added per replay."""
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
    graphs = tk._StepGraphs(cuda_device)
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
