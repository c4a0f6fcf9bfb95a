"""The d-space Krylov step without host round trips: ``krylov_step`` reads
nothing back to the host outside its subproblem call (on a card, the
subproblem kernel), its batched line search commits what the JAX
package's sequential ``while_loop`` commits, and ``CubicKrylov.step``
replays the step captured as a CUDA graph (``krylov_crn._StepGraphs``)
with the eager run's bits.

On the CPU the capture is stood in for by the step's own Python body,
called at every replay (the CPU has no CUDA graphs). The tests marked
``cuda`` capture and replay on the card."""

import types

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
from krylov_crn_tpu_torch.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu_torch.solvers import krylov_crn as tk
from krylov_crn_tpu_torch.utils import graphs as ug

CPU = "cpu"  # the library's default device is the card
HOST_READS = ("__bool__", "item", "__float__", "__int__", "tolist", "numpy")
KW = dict(m=10, beta=0.5, solver_eps=1e-8, solver_it_max=100,
          reorth_passes=1, reg_ceil=1e6)


@pytest.fixture(scope="module")
def problem():
    """The suite's 400 x 60 problem (tests/conftest.py), made here: the
    card's machine runs this file's cuda tests without the conftest."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    n, d = 400, 60
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.3)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return sp.csr_matrix(Ad), b, np.ones(d) * 0.5


def _loss(problem, dtype=np.float64, l2=0.0, want_dense=None, device=CPU):
    A, b, _ = problem
    return LogisticRegression(A, b, dtype=dtype, l2=l2,
                              want_dense=want_dense, device=device)


@pytest.mark.parametrize("dtype, l2", [(np.float32, 0.0), (np.float32, 1e-2),
                                       (np.float64, 1e-2)])
def test_step_makes_no_host_read_outside_the_subproblem(problem,
                                                        monkeypatch, dtype,
                                                        l2):
    loss = _loss(problem, dtype, l2)
    st = tk.initial_state(loss, problem[2], 1e-3, tk.KrylovState)
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
            calls.append(args[3].shape)
            return plain(*args, **kw)
        finally:
            banned["on"] = True

    monkeypatch.setattr(tk, "tridiag_secular", subproblem)
    try:
        for _ in range(3):
            st = tk.krylov_step(loss.data, loss.b_t, st, l2=l2, ls_max=20,
                                **KW)
    finally:
        banned["on"] = False
    assert calls == [(21,)] * 3  # one launch a step, all 21 candidates
    assert np.isfinite(float(st.value))


def _recorded_step(monkeypatch, loss, st, l2, ls_max):
    """One ``krylov_step`` with its Lanczos result, subproblem inputs and
    candidates recorded."""
    seen = {}
    for name in ("lanczos", "tridiag_secular", "_trials"):
        real = getattr(tk, name)

        def rec(*a, _real=real, _name=name, **k):
            seen[_name] = (a, _real(*a, **k))
            return seen[_name][1]

        monkeypatch.setattr(tk, name, rec)
    out = tk.krylov_step(loss.data, loss.b_t, st, l2=l2, ls_max=ls_max, **KW)
    return out, seen


def _sequential(st, seen, l2, ls_max):
    """The JAX package's backtracking loop over the same candidates, one
    host read per trial: trial k while k < ls_max and trial k is not
    accepted. Returns (k, the state it commits)."""
    tr = seen["_trials"][1]
    lz = seen["lanczos"][1]
    g_norm = seen["tridiag_secular"][0][2]
    cdt, adt = st.x.dtype, tr.regs.dtype
    k = 0
    while k < ls_max and not bool(ls_accept(
            tr.vhis[k], tr.vlos[k], st.value, st.value_lo,
            tr.model_decs[k])):
        k += 1
    x_new = tr.xs[k] if l2 else st.x + tr.S_c[k].clone() @ lz.V
    vhi, vlo = tr.vhis[k], tr.vlos[k]
    diff = (x_new - st.x).to(adt)
    better = pair_diff(vhi, vlo, st.f_best, st.f_best_lo) < 0
    return k, tk.KrylovState(
        x=x_new, Ax=tr.Axs[k], value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(tr.regs[k], KW["reg_ceil"]).to(cdt),
        r0=tr.lams[k].to(cdt), solver_it=st.solver_it + tr.its[k],
        diff_norm=torch.sqrt(torch.dot(diff, diff)).to(cdt),
        grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, vhi, st.f_best),
        f_best_lo=torch.where(better, vlo, st.f_best_lo))


# initial states whose line search accepts its first trial (reg 1.0), the
# fifth (reg 1e-3: four rejections), and none (reg 1e-3 with ls_max 2)
CASES = {"first": (1.0, 20), "after_rejects": (1e-3, 20), "none": (1e-3, 2)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype, l2", [(np.float64, 0.0), (np.float32, 0.0),
                                       (np.float64, 1e-2)])
def test_batched_line_search_commits_the_sequential_choice(
        problem, monkeypatch, case, dtype, l2):
    """The device-side pick (first accepted, else the last) and its
    commit by device indexing against a host loop over the same
    candidates: the same index and the same state, bit for bit."""
    reg, ls_max = CASES[case]
    loss = _loss(problem, dtype, l2)
    st = tk.initial_state(loss, problem[2], reg, tk.KrylovState)
    out, seen = _recorded_step(monkeypatch, loss, st, l2, ls_max)
    tr = seen["_trials"][1]
    assert tr.vhis.shape == (ls_max + 1,)
    # the regularizations: reg * beta, then sequential divisions by beta
    want = [st.reg_coef * KW["beta"]]
    for _ in range(ls_max):
        want.append(want[-1] / KW["beta"])
    assert torch.equal(tr.regs, torch.stack(want))
    k, seq = _sequential(st, seen, l2, ls_max)
    ok = ls_accept(tr.vhis, tr.vlos, st.value, st.value_lo, tr.model_decs)
    if case == "first":
        assert k == 0 and bool(ok[0])
    elif case == "after_rejects":
        assert 0 < k < ls_max and not bool(ok[:k].any())
    else:
        assert k == ls_max and not bool(ok.any())
    for f in tk.KrylovState._fields:
        assert torch.equal(getattr(out, f), getattr(seq, f)), f


def test_none_accepted_commits_the_last_trial_as_jax(problem):
    """No candidate accepted (ls_max 2, reg 1e-3): the step commits trial
    ls_max, as the JAX package's while_loop does (fp64, every field within
    1e-9, solver_it equal); the Gram step's freeze is not copied."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers import krylov_crn as jk
    from krylov_crn_tpu_torch.convert import krylov_state_from_numpy

    A, b, x0 = problem
    jl = JLoss(A, b, dtype=np.float64)
    ja = jk.CubicKrylov(loss=jl, reg_coef=1e-3, subspace_dim=10,
                        tolerance=0, tqdm=False)
    st_j = ja.init_state(jnp.asarray(x0), 0)
    out_j = jax.device_get(jk.krylov_step(jl.data, jl.b, st_j, l2=0.0,
                                          ls_max=2, accum_dtype=jnp.float64,
                                          **KW))
    loss = _loss(problem)
    st = krylov_state_from_numpy(jax.device_get(st_j), device=CPU)
    out = tk.krylov_step(loss.data, loss.b_t, st, l2=0.0, ls_max=2,
                         accum_dtype=torch.float64, **KW)
    # trial 2's reg, committed although it was not accepted
    assert float(out.reg_coef) == 1e-3 * 0.5 / 0.5 / 0.5
    assert float(out_j.reg_coef) == float(out.reg_coef)
    assert float(out.diff_norm) > 0
    assert int(out.solver_it) == int(out_j.solver_it)
    for f in ("x", "Ax", "r0", "diff_norm", "grad_norm"):
        got, want = getattr(out, f).numpy(), np.asarray(getattr(out_j, f))
        rel = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)
        assert rel < 1e-9, f
    assert abs((float(out.value) + float(out.value_lo))
               - (float(out_j.value) + float(out_j.value_lo))) < 1e-12


def _graphs_on_the_cpu(monkeypatch):
    """Replays that call the captured body itself, and CubicKrylov taking
    the replay path on the CPU."""
    def step_graphs(self):
        if self._graphs is None:
            self._graphs = tk._StepGraphs(self.state.x.device)
        return self._graphs

    monkeypatch.setattr(tk.CubicKrylov, "_step_graphs", step_graphs)
    monkeypatch.setattr(ug.StepGraphs, "_on_capture_stream",
                        lambda self, fn: fn())
    monkeypatch.setattr(ug.StepGraphs, "_record",
                        lambda self, body: types.SimpleNamespace(
                            replay=body))


def _solver(loss, **kw):
    return CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                       tolerance=0, **kw)


@pytest.mark.parametrize("dtype, want_dense", [(np.float32, True),
                                               (np.float64, False)])
def test_replayed_run_equals_eager_run(problem, monkeypatch, dtype,
                                       want_dense):
    """30 iterations through the run loop: the replayed run (one capture,
    a replay per step) and the eager run agree bit for bit."""
    x0 = problem[2]
    eager = _solver(_loss(problem, dtype, want_dense=want_dense))
    te = eager.run(x0, it_max=30)
    _graphs_on_the_cpu(monkeypatch)
    alg = _solver(_loss(problem, dtype, want_dense=want_dense))
    c0, r0 = tk.krylov_step.graph_captures, tk.krylov_step.graph_replays
    tr = alg.run(x0, it_max=30)
    assert tk.krylov_step.graph_captures - c0 == 1
    assert tk.krylov_step.graph_replays - r0 == 30
    assert tr.solver_its == te.solver_its
    assert list(tr.its) == list(te.its)
    for a, b in zip(tr.xs, te.xs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for f in tk.KrylovState._fields:
        assert torch.equal(getattr(alg.state, f), getattr(eager.state, f)), f


def test_graphs_follow_their_keys(problem, monkeypatch):
    """A second run on the instance replays the graph it captured; other
    step arguments capture a graph beside it; a new oracle (new data)
    drops the old graphs."""
    _graphs_on_the_cpu(monkeypatch)
    x0 = problem[2]
    alg = _solver(_loss(problem))
    c0, r0 = tk.krylov_step.graph_captures, tk.krylov_step.graph_replays

    def run(loss=None):
        alg.loss = alg.loss if loss is None else loss
        alg.reset(alg.loss)
        alg.run(x0, it_max=3)

    run()
    graphs = alg._graphs
    run()
    assert alg._graphs is graphs and len(graphs.graphs) == 1
    assert tk.krylov_step.graph_captures - c0 == 1
    assert tk.krylov_step.graph_replays - r0 == 6
    alg.ls_max = 10
    run()
    assert len(graphs.graphs) == 2
    assert tk.krylov_step.graph_captures - c0 == 2
    run(_loss(problem))
    assert len(graphs.graphs) == 1 and graphs.data is alg.loss.data
    assert tk.krylov_step.graph_captures - c0 == 3
    assert tk.krylov_step.graph_replays - r0 == 12


def test_step_graphs_only_on_one_card(problem):
    """The CPU runs eagerly (no graphs), whatever the data branch."""
    for want_dense in (True, False):
        alg = _solver(_loss(problem, want_dense=want_dense))
        alg.init_run(problem[2], 42)
        assert alg._step_graphs() is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps_on_card(problem, cuda_device):
    """The dense branch on the card: 8 replays of the captured step inside
    sync debug mode "error" against 8 eager steps, bit for bit, with the
    kernels' counts added per replay; the CSR branch replays too."""
    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.ops.subproblem import tridiag_secular

    loss = _loss(problem, np.float32, want_dense=True, device=cuda_device)
    alg = _solver(loss)
    alg.init_run(problem[2], 42)
    kw, st0 = alg._step_kwargs(), alg.state
    eager = [st0]
    for _ in range(8):
        eager.append(tk.krylov_step(loss.data, loss.b_t, eager[-1], **kw))
    graphs = alg._step_graphs()
    assert graphs is not None
    replayed = [st0, graphs.step(loss.data, loss.b_t, st0, kw)]
    m0, t0 = matvec.launches, tridiag_secular.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(7):
            replayed.append(graphs.step(loss.data, loss.b_t, replayed[-1],
                                        kw))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert matvec.launches - m0 == 7 * 21
    assert tridiag_secular.launches - t0 == 7
    for e, r in zip(eager, replayed):
        for f in tk.KrylovState._fields:
            assert torch.equal(getattr(e, f), getattr(r, f)), f
    sparse = _solver(_loss(problem, np.float32, want_dense=False,
                           device=cuda_device))
    sparse.init_run(problem[2], 42)
    assert sparse._step_graphs() is not None
