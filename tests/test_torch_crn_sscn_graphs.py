"""The CRN "full" and SSCN steps without host round trips: each step reads
the host once per block of line-search trials (``crn.read_resolved``) and
nowhere else outside its plain CPU subproblem, its blocked line search
commits what the sequential loop (the JAX package's ``while_loop``)
commits, for any block size, and ``CubicNewton.step`` / ``SSCN.step``
replay the steps captured as CUDA graphs with the eager runs' bits.

Tolerances: the blocked step evaluates a block's candidates in one batched
product where the loop made one product a trial, so the two agree in fp64
within 1e-12 relative (summation order), with the same committed trial and
the same solver_it; against the JAX package's fp64 step within 1e-11
relative. On the CPU the capture is stood in for by the steps' own Python
bodies, called at every replay; the tests marked ``cuda`` capture and
replay on the card."""

import functools
import types

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import SSCN, CubicNewton, LogisticRegression
from krylov_crn_tpu_torch.models.logistic import (
    logreg_partials,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu_torch.ops.subproblem import (
    cubic_solve_eigh,
    secular_newton,
    sym_eigh,
)
from krylov_crn_tpu_torch.solvers import crn as tc
from krylov_crn_tpu_torch.solvers import sscn as ts
from krylov_crn_tpu_torch.solvers.krylov_crn import initial_state
from krylov_crn_tpu_torch.utils import graphs as ug

CPU = "cpu"  # the library's default device is the card
HOST_READS = ("__bool__", "item", "__float__", "__int__", "tolist", "numpy")
KW = dict(beta=0.5, solver_eps=1e-8, solver_it_max=100, reg_ceil=1e6)
REL = 1e-12  # blocked against sequential, fp64
JAX_REL = 1e-11  # against the JAX package's fp64 step
M = 12  # SSCN's coordinates
# block sizes: one trial a block, the default, and one that needs a
# second block where the loop accepts its fifth trial
BLOCKS = (1, tc.LS_BLOCK, 3)


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


def _loss(problem, dtype=np.float64, l2=0.0, device=CPU):
    A, b, _ = problem
    return LogisticRegression(A, b, dtype=dtype, l2=l2, device=device)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _close(got, want, fields, rel=REL):
    for f in fields:
        if f in ("value_lo", "f_best_lo"):
            continue
        g, w = getattr(got, f), getattr(want, f)
        if f == "solver_it":
            assert int(g) == int(w), f
        else:
            assert _rel(g, w) <= rel, (f, _rel(g, w))


# ---- CRN "full" ----

def _crn_sequential(data, b, state, l2, ls_max, tolerance=0.0):
    """The loop the blocked step replaced (one trial and one host read at
    a time, the JAX while_loop's order), with the trial it commits."""
    adt = state.x.dtype
    g = tc.logreg_gradient_from_margins(data, b, state.Ax, state.x, l2=l2)
    g_norm = torch.sqrt(torch.dot(g, g))
    if bool(g_norm < tolerance):
        return tc._early(state, g_norm), None
    theta, Q = sym_eigh(tc.logreg_hessian_dense(data, state.Ax, l2=l2))
    regs = []

    def trial(reg, r0):
        regs.append(reg)
        return cubic_solve_eigh(theta, Q, g, reg, r0, xtol=KW["solver_eps"],
                                it_max=KW["solver_it_max"])

    out = tc._line_search(data, b, state, trial, l2, KW["beta"], ls_max, adt,
                          g_norm, KW["reg_ceil"])
    return out, len(regs) - 1


def _crn_state(problem, reg, dtype=np.float64, l2=0.0):
    loss = _loss(problem, dtype, l2)
    return loss, initial_state(loss, problem[2], reg, tc.CRNState)


# initial states whose line search accepts its first trial (reg 1.0), a
# later one (reg 1e-4: rejections first), and none (reg 1e-4, ls_max 2)
CASES = {"first": (1.0, 200), "after_rejects": (1e-4, 200),
         "none": (1e-4, 2)}


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_crn_blocks_commit_the_sequential_trial(problem, monkeypatch, case,
                                               block, l2):
    reg, ls_max = CASES[case]
    loss, st = _crn_state(problem, reg, l2=l2)
    want, k = _crn_sequential(loss.data, loss.b_t, st, l2, ls_max)
    monkeypatch.setattr(tc, "LS_BLOCK", block)
    reads0 = tc.read_resolved.count
    got = tc.crn_step_full(loss.data, loss.b_t, st, l2=l2, ls_max=ls_max,
                           **KW)
    reads = tc.read_resolved.count - reads0
    if case == "first":
        assert k == 0
    elif case == "after_rejects":
        assert 0 < k < ls_max
    else:
        assert k == ls_max  # nothing accepted: the loop's last trial
    assert reads == k // block + 1  # one read a block, up to trial k
    assert torch.equal(got.reg_coef, want.reg_coef)
    _close(got, want, tc.CRNState._fields)


def test_crn_after_rejects_needs_a_second_block(problem):
    """The case above that runs a further block at block 3 and the
    default: the committed trial lies past the first block."""
    loss, st = _crn_state(problem, CASES["after_rejects"][0])
    _, k = _crn_sequential(loss.data, loss.b_t, st, 0.0, 200)
    assert k >= 3


def _jax_crn(problem, reg, ls_max, tolerance, l2=0.0):
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers import crn as jc

    from krylov_crn_tpu_torch.convert import crn_state_from_numpy

    A, b, x0 = problem
    jl = JLoss(A, b, dtype=np.float64, l2=l2)
    ja = jc.CubicNewton(loss=jl, reg_coef=reg, cubic_solver="full",
                        tolerance=tolerance, tqdm=False)
    st_j = ja.init_state(jnp.asarray(x0), 0)
    out_j = jax.device_get(jc.crn_step_full(
        jl.data, jl.b, st_j, l2=l2, tolerance=tolerance, ls_max=ls_max,
        accum_dtype=jnp.float64, **KW))
    return crn_state_from_numpy(jax.device_get(st_j), device=CPU), out_j


@pytest.mark.parametrize("case", list(CASES))
def test_crn_step_matches_jax(problem, case):
    """The blocked step against the JAX package's step from the same fp64
    state, the all-reject case included (it commits trial ls_max)."""
    reg, ls_max = CASES[case]
    st, out_j = _jax_crn(problem, reg, ls_max, 0.0)
    loss = _loss(problem)
    out = tc.crn_step_full(loss.data, loss.b_t, st, ls_max=ls_max,
                           accum_dtype=torch.float64, **KW)
    if case == "none":
        assert float(out.reg_coef) == reg * 0.5 / 0.5 / 0.5
    _close(out, out_j, tc.CRNState._fields, JAX_REL)


def test_crn_early_exit_is_a_device_select(problem, monkeypatch):
    """A tolerance above the gradient norm: the step returns the state
    with diff_norm 0 and the gradient norm, as the JAX package's
    lax.cond does, reading the host once (the flag, already resolved)."""
    st, out_j = _jax_crn(problem, 1e-3, 200, 1e3)
    loss = _loss(problem)
    reads0 = tc.read_resolved.count
    out = tc.crn_step_full(loss.data, loss.b_t, st, tolerance=1e3,
                           accum_dtype=torch.float64, **KW)
    assert tc.read_resolved.count - reads0 == 1
    assert float(out.diff_norm) == 0.0
    assert torch.equal(out.x, st.x) and torch.equal(out.reg_coef,
                                                   st.reg_coef)
    _close(out, out_j, tc.CRNState._fields, JAX_REL)
    want, _ = _crn_sequential(loss.data, loss.b_t, st, 0.0, 200, 1e3)
    for f in tc.CRNState._fields:
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def _refuse_reads(monkeypatch, modules):
    """Tensor host reads raise, except inside the plain CPU subproblem
    (scipy's eigh, the Newton loop's flag) and the flag's read."""
    banned = {"on": True}

    def refuse(name, real):
        def read(self, *a, **k):
            if banned["on"]:
                raise AssertionError(f"host read through Tensor.{name}")
            return real(self, *a, **k)
        return read

    def allowed(fn):
        @functools.wraps(fn)  # with its counter
        def call(*a, **k):
            banned["on"] = False
            try:
                return fn(*a, **k)
            finally:
                banned["on"] = True
        return call

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(name, getattr(torch.Tensor, name)))
    for mod in modules:
        for name in ("sym_eigh", "eig_secular", "read_resolved"):
            monkeypatch.setattr(mod, name, allowed(getattr(mod, name)))
    return banned


@pytest.mark.parametrize("dtype, l2", [(np.float32, 0.0),
                                       (np.float64, 1e-2)])
def test_steps_make_no_host_read_but_the_flag(problem, monkeypatch, dtype,
                                              l2):
    loss = _loss(problem, dtype, l2)
    st = initial_state(loss, problem[2], 1e-4, tc.CRNState)
    sloss = _loss(problem, dtype, l2)
    sst = SSCN(loss=sloss, reg_coef=1e-4, subspace_dim=M).init_state(
        problem[2], 42)
    I = torch.from_numpy(np.random.default_rng(0).choice(60, M,
                                                         replace=False))
    banned = _refuse_reads(monkeypatch, (tc, ts))
    try:
        for _ in range(3):
            st = tc.crn_step_full(loss.data, loss.b_t, st, l2=l2, **KW)
            sst = ts.sscn_step(sloss.data, sloss.b_t, sst, I, l2=l2,
                               beta=0.5, reg_ceil=1e6)
    finally:
        banned["on"] = False
    assert np.isfinite(float(st.value)) and np.isfinite(float(sst.value))


# ---- SSCN ----

def _sscn_sequential(data, b, state, I, l2, ls_max):
    """The loop the blocked SSCN step replaced, with the trial it
    commits."""
    adt = state.x.dtype
    x, Ax = state.x, state.Ax
    g, H, B = logreg_partials(data, b, Ax, x, I, l2=l2)
    theta, Q = sym_eigh(H)
    c = Q.T @ g
    r0 = state.r0

    def trial(reg):
        lams, its = secular_newton(theta, c, reg.reshape(1), r0,
                                   xtol=ts.FP64_EPS, it_max=100)
        lam, it = lams[0], its[0]
        u = -c / (theta + lam)
        s = Q @ u
        norm_s = torch.sqrt(torch.sum(u * u))
        model_dec = (lam / 2.0 * norm_s ** 2 - reg / 3.0 * norm_s ** 3
                     - torch.dot(g, s) / 2.0)
        x_new = x.index_put((I,), x[I] + s)
        Ax_new = Ax + B @ s
        vhi, vlo = logreg_value_from_margins(b, Ax_new, x_new, l2=l2,
                                             **value_args(data))
        return lam, it, model_dec, x_new, Ax_new, vhi, vlo

    reg = torch.clamp(state.reg_coef * 0.5, min=ts.FP64_EPS)
    lam, it, md, x_new, Ax_new, vhi, vlo = trial(reg)
    k = 0
    while k < ls_max and not bool(ls_accept(vhi, vlo, state.value,
                                            state.value_lo, md)):
        reg = reg / 0.5
        lam, it, md, x_new, Ax_new, vhi, vlo = trial(reg)
        k += 1
    diff = x_new - x
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return ts.SSCNState(
        x=x_new, Ax=Ax_new, value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(reg, 1e6), r0=lam,
        solver_it=state.solver_it + it,
        diff_norm=torch.sqrt(torch.dot(diff, diff)),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo)), k


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_sscn_blocks_commit_the_sequential_trial(problem, monkeypatch, case,
                                                block, l2):
    reg, ls_max = CASES[case]
    loss = _loss(problem, l2=l2)
    st = SSCN(loss=loss, reg_coef=reg, subspace_dim=M).init_state(
        problem[2], 42)
    I = torch.from_numpy(np.random.default_rng(3).choice(60, M,
                                                         replace=False))
    want, k = _sscn_sequential(loss.data, loss.b_t, st, I, l2, ls_max)
    monkeypatch.setattr(tc, "LS_BLOCK", block)
    reads0 = tc.read_resolved.count
    got = ts.sscn_step(loss.data, loss.b_t, st, I, l2=l2, beta=0.5,
                       ls_max=ls_max, reg_ceil=1e6)
    if case == "first":
        assert k == 0
    elif case == "none":
        assert k == ls_max
    assert tc.read_resolved.count - reads0 == k // block + 1
    assert torch.equal(got.reg_coef, want.reg_coef)
    _close(got, want, ts.SSCNState._fields)


def test_sscn_after_rejects_needs_a_second_block(problem):
    loss = _loss(problem)
    st = SSCN(loss=loss, reg_coef=CASES["after_rejects"][0],
              subspace_dim=M).init_state(problem[2], 42)
    I = torch.from_numpy(np.random.default_rng(3).choice(60, M,
                                                         replace=False))
    _, k = _sscn_sequential(loss.data, loss.b_t, st, I, 0.0, 200)
    assert k >= 3


@pytest.mark.parametrize("case", list(CASES))
def test_sscn_step_matches_jax(problem, case):
    """The blocked SSCN step against the JAX package's, fed the JAX
    step's own coordinates, the all-reject case included."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers import sscn as js

    from krylov_crn_tpu_torch.convert import sscn_state_from_numpy

    reg, ls_max = CASES[case]
    A, b, x0 = problem
    jl = JLoss(A, b, dtype=np.float64)
    st_j = js.SSCN(loss=jl, reg_coef=reg, subspace_dim=M,
                   tqdm=False).init_state(jnp.asarray(x0), 0)
    _, sub = jax.random.split(st_j.key)
    I = np.array(jax.random.choice(sub, A.shape[1], shape=(M,),
                                   replace=False), np.int64)
    out_j = jax.device_get(js.sscn_step(
        jl.data, jl.b, st_j, m=M, l2=0.0, beta=0.5, solver_it_max=100,
        ls_max=ls_max, reg_ceil=1e6, accum_dtype=jnp.float64))
    loss = _loss(problem)
    st = sscn_state_from_numpy(jax.device_get(st_j), device=CPU)
    out = ts.sscn_step(loss.data, loss.b_t, st, torch.from_numpy(I),
                       beta=0.5, ls_max=ls_max, reg_ceil=1e6,
                       accum_dtype=torch.float64)
    _close(out, out_j, ts.SSCNState._fields, JAX_REL)


# ---- replayed runs ----

def _graphs_on_the_cpu(monkeypatch):
    """Replays that call the captured bodies themselves, and both solvers
    taking the replay path on the CPU."""
    def crn_graphs(self):
        if self._graphs is None:
            self._graphs = tc._FullGraphs(self.state.x.device)
        return self._graphs

    def sscn_graphs(self):
        if self._graphs is None:
            self._graphs = ts._SSCNGraphs(self.state.x.device)
        return self._graphs

    monkeypatch.setattr(tc.CubicNewton, "_step_graphs", crn_graphs)
    monkeypatch.setattr(ts.SSCN, "_step_graphs", sscn_graphs)
    monkeypatch.setattr(ug.StepGraphs, "_on_capture_stream",
                        lambda self, fn: fn())
    monkeypatch.setattr(ug.StepGraphs, "_record",
                        lambda self, body: types.SimpleNamespace(
                            replay=body))


def _crn(loss, **kw):
    return CubicNewton(loss=loss, reg_coef=1e-4, cubic_solver="full", **kw)


def _sscn(loss):
    return SSCN(loss=loss, reg_coef=1e-4, subspace_dim=M)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("make, step", [(_crn, tc.crn_step_full),
                                        (_sscn, ts.sscn_step)])
def test_replayed_run_equals_eager_run(problem, monkeypatch, dtype, make,
                                       step):
    """25 iterations through the run loop: the replayed run (one capture
    of the step and, where a step needs one, of the further block) and
    the eager run agree bit for bit, with one step replay an iteration,
    one further-block replay per extra block and the same ``ls_blocks``."""
    x0 = problem[2]
    eager = make(_loss(problem, dtype))
    te = eager.run(x0, it_max=25)
    _graphs_on_the_cpu(monkeypatch)
    alg = make(_loss(problem, dtype))
    c0, r0 = step.graph_captures, step.graph_replays
    b0 = step.block_replays
    tr = alg.run(x0, it_max=25)
    blocks = alg.trace.metrics["ls_blocks"]
    assert blocks == eager.trace.metrics["ls_blocks"]
    assert step.graph_replays - r0 == 25
    assert step.block_replays - b0 == sum(blocks)
    assert step.graph_captures - c0 == 1 + (sum(blocks) > 0)
    assert tr.solver_its == te.solver_its
    for f in type(alg.state)._fields:
        assert torch.equal(getattr(alg.state, f), getattr(eager.state, f)), f


def test_crn_replayed_run_runs_further_blocks(problem, monkeypatch):
    """The CRN run above does need further blocks (its converged steps
    reject trials), so the second graph is exercised."""
    _graphs_on_the_cpu(monkeypatch)
    alg = _crn(_loss(problem))
    alg.run(problem[2], it_max=25)
    assert sum(alg.trace.metrics["ls_blocks"]) > 0


def test_step_graphs_only_on_one_card(problem):
    """The CPU runs eagerly, and CRN "CG" keeps its host loop."""
    loss = _loss(problem)
    for alg in (_crn(loss), _sscn(loss),
                CubicNewton(loss=loss, cubic_solver="CG")):
        alg.init_run(problem[2], 42)
        assert alg._step_graphs() is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("make, step", [(_crn, tc.crn_step_full),
                                        (_sscn, ts.sscn_step)])
def test_replayed_run_equals_eager_run_on_card(problem, cuda_device, make,
                                               step):
    """fp32 on the card: 12 replayed iterations against 12 eager steps
    from the same coordinates, bit for bit, the kernels' launches counted
    per replay (one eigh and one Newton launch per block)."""
    from krylov_crn_tpu_torch.ops.eigh import sym_eigh as eigh
    from krylov_crn_tpu_torch.ops.subproblem import eig_secular

    loss = _loss(problem, np.float32, device=cuda_device)
    alg = make(loss)
    e0, s0 = eigh.launches, eig_secular.launches
    r0 = step.graph_replays
    tr = alg.run(problem[2], it_max=12)
    blocks = sum(alg.trace.metrics["ls_blocks"])
    assert step.graph_replays - r0 == 12
    assert eig_secular.launches - s0 == 12 + blocks + (
        1 + (blocks > 0))  # the captures' warm-up blocks
    assert eigh.launches - e0 == 12 + 1
    eager = make(loss)
    eager.init_run(problem[2], 42)
    eager._step_graphs = lambda: None
    te = eager.run(problem[2], it_max=12)
    assert tr.solver_its == te.solver_its
    for f in type(alg.state)._fields:
        assert torch.equal(getattr(alg.state, f), getattr(eager.state, f)), f
