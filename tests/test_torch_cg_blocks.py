"""GramCRN's CG in masked blocks (krylov_crn_tpu_torch/solvers/crn_gram.py):
``cg_rep`` runs ``CG_BLOCK`` iterations between host reads of its
stopping flag, and an iteration past the stop changes no bit, so a
blocked solve equals the loop that reads the flag every iteration (the
JAX package's ``while_loop``), iterates and iteration counts alike. On one
card GramCRN replays each block as a captured CUDA graph
(``crn_gram._CGGraphs``).

On the CPU the capture is stood in for by the block's own Python body,
called at every replay. The test marked ``cuda`` captures and replays on
the card."""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch import GramCRN, LogisticRegression
from krylov_crn_tpu_torch.ops.gram import Rep, rep_axpy, rep_dot
from krylov_crn_tpu_torch.solvers import crn_gram as tcg
from krylov_crn_tpu_torch.utils import graphs as ug

CPU = "cpu"  # the library's default device is the card


@pytest.fixture(scope="module")
def gram_problem():
    """test_torch_gram_crn.py's wide problem (n << d), made here: the
    card's machine runs this file's cuda test without the conftest."""
    rng = np.random.default_rng(11)
    n, d = 300, 700
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.4 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return sp.csr_matrix(Ad), b, np.ones(d) * 0.5


def _solver(problem, dtype, l2, device=CPU):
    A, b, _ = problem
    return GramCRN(loss=LogisticRegression(A, b, dtype=dtype, l2=l2,
                                           device=device),
                   reg_coef=1e-3, tolerance=0, device=device)


def _cg_loop(gd, matvec, b, rtol, maxiter, adt):
    """CG reading its stopping flag every iteration: the loop the blocks
    replaced (the JAX package's ``while_loop``, one host read each)."""
    cdt = b.w.dtype
    dot = lambda u, v: rep_dot(gd, u, v, adt)
    bnorm2 = dot(b, b)
    tol2 = (rtol * rtol) * bnorm2
    z = torch.zeros(b.w.shape[0], dtype=cdt, device=b.w.device)
    x = Rep(torch.zeros((), dtype=cdt, device=b.w.device), z, z)
    r = p = b
    gamma, it = bnorm2, 0
    while it < maxiter and bool(gamma > tol2):
        Ap = matvec(p)
        alpha = (gamma / dot(p, Ap)).to(cdt)
        x = rep_axpy(x, alpha, p)
        r = rep_axpy(r, -alpha, Ap)
        gamma_new = dot(r, r)
        beta = (gamma_new / gamma).to(cdt)
        p = Rep(r.beta + beta * p.beta, r.w + beta * p.w, r.u + beta * p.u)
        gamma = gamma_new
        it += 1
    return x, it


def _system(problem, dtype, l2, lam, device=CPU):
    """(gd, D, rhs, lam_c, matvec, adt) of GramCRN's first CG system at
    the shift ``lam``, from the initial state."""
    alg = _solver(problem, dtype, l2, device)
    alg.init_run(problem[2], 42)
    adt = alg.state.zeta.dtype
    g, _, D, _, _ = tcg._grad_probe(alg.gd, alg.state, l2, adt)
    lam_c = torch.full((), lam, dtype=adt, device=alg.gd.K.device)
    hop = tcg._hop(alg.gd, D, l2)
    mv = lambda v: rep_axpy(hop(v), lam_c, v)
    return alg.gd, D, Rep(-g.beta, -g.w, -g.u), lam_c, mv, adt


# (dtype, l2, lam, block, maxiter, what the block does to the count): 24
# iterations in fp64 at lam 1e-2, 23 in fp32 at l2 1e-2 and lam 1e-3
CASES = {
    "divides": (np.float64, 0.0, 1e-2, 4, 500),
    "does_not_divide": (np.float64, 0.0, 1e-2, 5, 500),
    "maxiter_mid_block": (np.float64, 0.0, 1e-2, 4, 10),
    "fp32": (np.float32, 1e-2, 1e-3, 4, 500),
    "no_iteration": (np.float64, 0.0, 1e-2, 4, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_cg_equals_the_loop(gram_problem, monkeypatch, case):
    """The blocked solve against the per-iteration loop: the same bits of
    x and the same iteration count, and one host read per block."""
    dtype, l2, lam, block, maxiter = CASES[case]
    gd, D, rhs, lam_c, mv, adt = _system(gram_problem, dtype, l2, lam)
    x_want, its_want = _cg_loop(gd, mv, rhs, 1e-8, maxiter, adt)
    full = _cg_loop(gd, mv, rhs, 1e-8, 500, adt)[1]
    if case == "divides":
        assert its_want % block == 0 and its_want > block
    elif case in ("does_not_divide", "fp32"):
        assert its_want % block != 0 and its_want > block
    elif case == "maxiter_mid_block":
        assert its_want == maxiter < full and maxiter % block != 0
    else:
        assert its_want == 0
    monkeypatch.setattr(tcg, "CG_BLOCK", block)
    reads0, its0 = tcg.host_read.count, tcg.cg_rep.iterations
    x, its = tcg.cg_rep(gd, mv, rhs, 1e-8, maxiter, adt)
    assert its == its_want
    assert tcg.cg_rep.iterations - its0 == its
    assert tcg.host_read.count - reads0 == max(1, -(-its // block))
    for f in Rep._fields:
        assert torch.equal(getattr(x, f), getattr(x_want, f)), f


def _graphs_on_the_cpu(monkeypatch):
    """Block replays that call the captured body itself, and GramCRN
    taking the replay path on the CPU."""
    def cg_graphs(self):
        if self._cg_graphs is None:
            self._cg_graphs = tcg._CGGraphs(self.state.zeta.device)
        return self._cg_graphs

    monkeypatch.setattr(tcg.GramCRN, "_cg_block_graphs", cg_graphs)
    monkeypatch.setattr(ug.StepGraphs, "_on_capture_stream",
                        lambda self, fn: fn())
    monkeypatch.setattr(ug.StepGraphs, "_record",
                        lambda self, body: types.SimpleNamespace(
                            replay=body))


@pytest.mark.parametrize("dtype, l2, its", [(np.float64, 0.0, 4),
                                            (np.float32, 1e-2, 10)])
def test_replayed_blocks_equal_eager_blocks(gram_problem, monkeypatch,
                                            dtype, l2, its):
    """GramCRN runs with every CG block replayed against the eager run:
    the same exact values, rollbacks (fp32, l2 = 1e-2: past its fp32
    floor) and state bits; one capture, a replay per host read of a CG
    flag."""
    x0 = gram_problem[2]
    eager = _solver(gram_problem, dtype, l2)
    te = eager.run(x0, it_max=its)
    _graphs_on_the_cpu(monkeypatch)
    alg = _solver(gram_problem, dtype, l2)
    c0, r0 = tcg.cg_rep.graph_captures, tcg.cg_rep.block_replays
    tr = alg.run(x0, it_max=its)
    assert tcg.cg_rep.graph_captures - c0 == 1
    replays = tcg.cg_rep.block_replays - r0
    assert sum(tr.metrics["cg_its"]) / 4 <= replays < sum(
        tr.metrics["cg_its"])
    for key in ("cg_its", "host_reads", "exact_fs", "rollback_its"):
        assert tr.metrics.get(key) == te.metrics.get(key), key
    if dtype == np.float32:
        assert tr.metrics["rollback_its"]
    assert tr.solver_its == te.solver_its
    for f in tcg.GramKrylovState._fields:
        assert torch.equal(getattr(alg.state, f), getattr(eager.state, f)), f


def test_cg_graphs_only_on_one_card(gram_problem):
    alg = _solver(gram_problem, np.float64, 0.0)
    alg.init_run(gram_problem[2], 42)
    assert alg._cg_block_graphs() is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_blocks_equal_the_loop_on_card(gram_problem, cuda_device):
    """A CG solve of replayed blocks on the card against the per-iteration
    loop: the same bits and count, one replay and one host read per
    block, and a SYMV launch counted per iteration of every block."""
    from krylov_crn_tpu_torch.ops.symv import symv

    gd, D, rhs, lam_c, mv, adt = _system(gram_problem, np.float32, 1e-2,
                                         1e-3, cuda_device)
    x_want, its_want = _cg_loop(gd, mv, rhs, 1e-8, 500, adt)
    graphs = tcg._CGGraphs(cuda_device)
    graphs.solve(gd, D, rhs, lam_c, 1e-2, 1e-8, 500, adt)  # the capture
    reads0, r0 = tcg.host_read.count, tcg.cg_rep.block_replays
    s0 = symv.launches
    x, its = graphs.solve(gd, D, rhs, lam_c, 1e-2, 1e-8, 500, adt)
    blocks = -(-its_want // tcg.CG_BLOCK)
    assert its == its_want
    assert tcg.host_read.count - reads0 == blocks
    assert tcg.cg_rep.block_replays - r0 == blocks
    assert symv.launches - s0 == blocks * tcg.CG_BLOCK
    for f in Rep._fields:
        assert torch.equal(getattr(x, f), getattr(x_want, f)), f
