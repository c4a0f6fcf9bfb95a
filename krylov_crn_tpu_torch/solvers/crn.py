"""Full-space Cubic Regularized Newton with line search (Nesterov-Polyak).

Port of ``krylov_crn_tpu/solvers/crn.py`` (reference cubic.py:115-235).
Two subproblem backends, the reference's switch (cubic_newton.py:76-82):

* ``"full"`` (small d): the dense Hessian, eigendecomposed once per step
  (``ops/eigh.sym_eigh``: on a card the hand-written Jacobi kernel);
  every secular evaluation of every line-search trial is then O(d);
* ``"CG"`` (large d): matrix-free, every secular evaluation is a CG solve
  over HVPs (the reference's Newton x CG x SpMV nest, cubic.py:152-182).

The gradient-norm early exit (cubic.py:201-202) zeroes the step so the
run loop's iterate-diff tolerance fires, as in the reference.

The JAX package runs the "full" step as one XLA program (``lax.cond`` and a
``while_loop`` line search). Here it reads the host once: the early exit
is a device-side select, and the line search evaluates ``LS_BLOCK``
trials at once (the same regularizations: reg_coef * beta, then k
sequential divisions by beta, every trial's Newton from the committed
r0), commits the first accepted one on the device, else trial ``ls_max``
as the JAX loop does, and leaves a flag, resolved, that the host reads
after each block (``read_resolved``); further blocks run only while it
reads False. On one card ``CubicNewton.step`` replays the step (the
factorization and the first block) captured as a CUDA graph, and each
further block as a second graph (``utils/graphs``); the eigh and the
candidates' Newton are the kernels ``csrc/eigh.cu`` and
``csrc/subproblem.cu`` (``eig_secular``). On the CPU the step runs
eagerly. The ``"CG"`` backend keeps the Python loop with one host read per
decision and also runs on row-sharded data
(``parallel.sharded.ShardedDual``), one all-reduce per HVP; ``"full"``
needs the dense copy of A, which sharded data does not keep.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.models.logistic import (
    data_mask,
    hessian_weights,
    logreg_gradient_from_margins,
    logreg_hessian_dense,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.math import (
    fold,
    over_n,
    ls_accept,
    pair_diff,
    reg_clamp,
)
from krylov_crn_tpu_torch.data.formats import DualSparse
from krylov_crn_tpu_torch.ops.eigh import sym_eigh
from krylov_crn_tpu_torch.ops.matvec import matvec
from krylov_crn_tpu_torch.ops.spmv import dense_matvec, rmatvec, spmv
from krylov_crn_tpu_torch.ops.subproblem import cubic_solve_cg, eig_secular
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers.krylov_crn import _data_ptrs, initial_state
from krylov_crn_tpu_torch.solvers.krylov_gram import _pick
from krylov_crn_tpu_torch.utils.graphs import StepGraphs
from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["CubicNewton", "CRNState", "crn_step_full", "crn_step_cg",
           "LS_BLOCK", "Search", "read_resolved"]

# Line-search trials per block. The step evaluates one block and the host
# reads its flag once; a further block runs only when none of the block's
# trials was accepted (and the block did not reach trial ls_max). A block
# costs about B dense products and B value folds, so a larger B buys fewer
# reads with work past the accepted trial; CRN on w8a-like accepts its
# first or second trial after the first few steps.
LS_BLOCK = 4


class CRNState(NamedTuple):
    x: torch.Tensor
    Ax: torch.Tensor
    value: torch.Tensor  # f(x) two-float hi part
    value_lo: torch.Tensor
    reg_coef: torch.Tensor
    r0: torch.Tensor
    solver_it: torch.Tensor
    diff_norm: torch.Tensor
    grad_norm: torch.Tensor
    f_best: torch.Tensor
    f_best_lo: torch.Tensor


def _line_search(data, b, state, trial, l2, beta, ls_max, adt, g_norm,
                 reg_ceil):
    """Backtracking from reg*beta by 1/beta until the two-float accept
    test passes (<= ls_max retries), then the committed state."""
    reg = state.reg_coef.to(adt) * beta
    r0 = state.r0.to(adt)
    sol = trial(reg, r0)
    x_new = state.x + sol.s.to(state.x.dtype)

    def value_at(x_new):
        Ax_new = spmv(data, x_new)
        vhi, vlo = logreg_value_from_margins(b, Ax_new, x_new, l2=l2,
                                             **value_args(data))
        return Ax_new, vhi, vlo

    Ax_new, vhi, vlo = value_at(x_new)
    trials = 0
    while trials < ls_max and not bool(ls_accept(
            vhi, vlo, state.value, state.value_lo,
            sol.model_decrease.to(adt))):
        reg = reg / beta
        sol = trial(reg, r0)
        x_new = state.x + sol.s.to(state.x.dtype)
        Ax_new, vhi, vlo = value_at(x_new)
        trials += 1

    return _finish(state, x_new, Ax_new, vhi, vlo, reg, sol.r, sol.iterations,
                   g_norm, adt, reg_ceil)


def _finish(state, x_new, Ax_new, vhi, vlo, reg, lam, it, g_norm, adt,
            reg_ceil):
    """The state the line search commits (the JAX package's ``_finish``)."""
    cdt = state.x.dtype
    diff = x_new - state.x
    diff_norm = torch.sqrt(torch.dot(diff.to(adt), diff.to(adt)))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return CRNState(
        x=x_new, Ax=Ax_new, value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(reg, reg_ceil).to(cdt),
        r0=lam.to(cdt),
        solver_it=state.solver_it + it,
        diff_norm=diff_norm.to(cdt), grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )


def _early(state, g_norm):
    return state._replace(diff_norm=torch.zeros_like(state.diff_norm),
                          grad_norm=g_norm.to(state.x.dtype))


class Search(NamedTuple):
    """What the blocked line search carries from one block to the next."""

    reg: torch.Tensor  # the last regularization evaluated
    trial: torch.Tensor  # the next trial's index (int64)
    resolved: torch.Tensor  # the committed trial is found (or early exit)


def read_resolved(search: Search) -> bool:
    """The host's read of a step's flag, once per block;
    ``read_resolved.count`` counts them."""
    read_resolved.count += 1
    with span("search.read"):
        return bool(search.resolved)


read_resolved.count = 0


def block_regs(first, beta: float, block: int):
    """A block's regularizations: ``first``, then each one the previous
    one divided by beta (the JAX loop's sequential roundings)."""
    regs = [first]
    for _ in range(block - 1):
        regs.append(regs[-1] / beta)
    return torch.stack(regs)


def block_pick(ok, search: Search, ls_max: int, block: int):
    """(the block's committed row as a 1-element index, found): the first
    accepted trial of the block, else trial ls_max where the block holds
    it (the JAX loop's last trial); trials past ls_max are not
    candidates."""
    k = search.trial + torch.arange(block, device=ok.device)
    pick = (ok & (k <= ls_max)) | (k == ls_max)
    idx = torch.argmax(pick.to(torch.int32)).reshape(1)
    return idx, pick.any()


def commit(new, found_state, found, search: Search, regs, block: int):
    """The block's state where it resolves the search first, else the
    state committed so far; and the carry to the next block."""
    take = found & ~search.resolved
    new = type(new)(*(torch.where(take, f, o)
                      for f, o in zip(found_state, new)))
    return new, Search(reg=regs[-1], trial=search.trial + block,
                       resolved=search.resolved | found)


class _Factor(NamedTuple):
    """What every block of a "full" step shares."""

    g: torch.Tensor  # gradient, accumulation dtype
    g_norm: torch.Tensor
    theta: torch.Tensor  # eigenvalues of H, ascending
    Q: torch.Tensor
    c: torch.Tensor  # Q^T g


def _full_factor(data, b, state: CRNState, l2, adt) -> _Factor:
    g = logreg_gradient_from_margins(data, b, state.Ax, state.x, l2=l2)
    g = g.to(adt)
    g_norm = torch.sqrt(torch.dot(g, g))
    H = logreg_hessian_dense(data, state.Ax, l2=l2).to(adt)
    theta, Q = sym_eigh(H)  # factor once; O(d) per trial after
    return _Factor(g=g, g_norm=g_norm, theta=theta, Q=Q, c=Q.T @ g)


def _full_block(data, b, state: CRNState, fac: _Factor, search: Search,
                new: CRNState, first: bool, l2, beta, solver_eps,
                solver_it_max, ls_max, adt, reg_ceil):
    """One block of ``LS_BLOCK`` line-search trials: every trial's Newton
    (one ``eig_secular`` launch on a card), step, full product and value,
    the pick and its commit. No host read."""
    cdt = state.x.dtype
    block = LS_BLOCK
    first_reg = (state.reg_coef.to(adt) * beta if first
                 else search.reg / beta)
    regs = block_regs(first_reg, beta, block)
    lams, its = eig_secular(fac.theta, fac.c, regs,
                            state.r0.to(adt).reshape(1), xtol=solver_eps,
                            it_max=solver_it_max)
    cz = fac.c != 0
    U = torch.where(cz, -fac.c / torch.where(
        cz, fac.theta[None, :] + lams[:, None], 1.0), 0.0)
    S = U @ fac.Q.T  # rows: Q @ u
    norm_s = torch.sqrt(torch.sum(U * U, dim=1))
    model_decs = (lams / 2.0 * norm_s ** 2 - regs / 3.0 * norm_s ** 3
                  - (S @ fac.g) / 2.0)
    xs = state.x[None, :] + S.to(cdt)
    # the JAX trial's full product, one per candidate
    Axs = torch.stack([spmv(data, xs[k]) for k in range(block)])
    vhis, vlos = logreg_value_from_margins(b, Axs, xs, l2=l2,
                                           **value_args(data))
    ok = ls_accept(vhis, vlos, state.value, state.value_lo, model_decs)
    idx, found = block_pick(ok, search, ls_max, block)
    done = _finish(state, _pick(xs, idx), _pick(Axs, idx), _pick(vhis, idx),
                   _pick(vlos, idx), _pick(regs, idx), _pick(lams, idx),
                   _pick(its, idx), fac.g_norm, adt, reg_ceil)
    return commit(new, done, found, search, regs, block)


def _full_first(data, b, state: CRNState, fac: _Factor, tolerance, kw):
    """The early exit's select and the first block: (committed state,
    carry)."""
    early = fac.g_norm < tolerance
    dev = state.x.device
    # reg is not read: the first block starts from reg_coef
    search = Search(reg=fac.g_norm, trial=torch.zeros(
        (), dtype=torch.int64, device=dev), resolved=early)
    return _full_block(data, b, state, fac, search,
                       _early(state, fac.g_norm), True, **kw)


def crn_step_full(
    data,
    b: torch.Tensor,
    state: CRNState,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    tolerance: float = 0.0,
    ls_max: int = 200,
    accum_dtype=None,
    reg_ceil: float = 1e6,
) -> CRNState:
    """One CRN iteration with the dense-eigh subproblem backend: blocks of
    ``LS_BLOCK`` trials until the flag reads resolved (one host read per
    block)."""
    adt = state.x.dtype if accum_dtype is None else accum_dtype
    kw = dict(l2=l2, beta=beta, solver_eps=solver_eps,
              solver_it_max=solver_it_max, ls_max=ls_max, adt=adt,
              reg_ceil=reg_ceil)
    fac = _full_factor(data, b, state, l2, adt)
    new, search = _full_first(data, b, state, fac, tolerance, kw)
    while not read_resolved(search):
        new, search = _full_block(data, b, state, fac, search, new, False,
                                  **kw)
    return new


crn_step_full.graph_captures = 0
crn_step_full.graph_replays = 0
crn_step_full.block_replays = 0

# the step's kernels, by their Python counters (utils/graphs)
_COUNTERS = ((matvec, "launches"), (matvec, "shape_launches"),
             (dense_matvec, "cuda_calls"), (sym_eigh, "launches"),
             (eig_secular, "launches"), (fold, "launches"))


class SearchGraphs(StepGraphs):
    """A step with a blocked line search (``crn_step_full``, ``sscn_step``)
    on one card as two CUDA graphs over the static state buffers: the step
    (``first(state) -> (factor, committed state, carry)``: the
    factorization and the first block) and a further block (``further(
    state, factor, carry, committed) -> (committed, carry)``), captured at
    its first use. A step is one replay of the step, the flag read, a
    replay of the further block while it reads False, and the committed
    state cloned out. The step's replays count in ``step.graph_replays``,
    the further blocks' in ``step.block_replays``."""

    def __init__(self, device, step):
        super().__init__(device, _COUNTERS, (step, "graph_captures"),
                         (step, "graph_replays"))
        self.step_fn = step
        self.data = None

    def on(self, data):
        """Graphs of ``data``: other data's are dropped."""
        if self.data is not data:
            self.graphs.clear()
            self.data = data

    def run(self, key, first, further):
        entry = self.graphs.get(key)
        if entry is None:
            out = self.graphs[("out",) + key] = {}

            def body():
                out["fac"], out["new"], out["search"] = first(self.state)

            entry = self.capture(key, body, lambda: first(self.clone()))
        self.replay(entry)
        out = self.graphs[("out",) + key]
        while not read_resolved(out["search"]):
            self._further(("block",) + key, out, further)
        return type(self.state)(*(t.clone() for t in out["new"]))

    def _further(self, key, out, further):
        entry = self.graphs.get(key)
        if entry is None:
            def run():
                return further(self.state, out["fac"], out["search"],
                               out["new"])

            def body():
                new, search = run()
                for dst, src in zip((*out["new"], *out["search"]),
                                    (*new, *search)):
                    dst.copy_(src)

            entry = self.capture(key, body, run,
                                 replays=(self.step_fn, "block_replays"))
        self.replay(entry)


class _FullGraphs(SearchGraphs):
    """``crn_step_full`` on one card, keyed on the step's keyword
    arguments, ``LS_BLOCK`` and the data's and labels' addresses."""

    def __init__(self, device):
        super().__init__(device, crn_step_full)

    def step(self, data: DualSparse, b, state: CRNState, kw: dict):
        self.on(data)
        self.buffers(state)
        self.load(state)
        kw = dict(kw)
        tol = kw.pop("tolerance")
        key = (tuple(sorted(kw.items())), tol, LS_BLOCK, _data_ptrs(data),
               b.data_ptr())

        def first(st):
            fac = _full_factor(data, b, st, kw["l2"], kw["adt"])
            return (fac, *_full_first(data, b, st, fac, tol, kw))

        return self.run(key, first, lambda st, fac, search, new: _full_block(
            data, b, st, fac, search, new, False, **kw))


def crn_step_cg(
    data,
    b: torch.Tensor,
    state: CRNState,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    tolerance: float = 0.0,
    ls_max: int = 200,
    cg_maxiter: int | None = None,
    accum_dtype=None,
    reg_ceil: float = 1e6,
) -> CRNState:
    """One CRN iteration with the matrix-free CG subproblem backend."""
    adt = state.x.dtype if accum_dtype is None else accum_dtype
    n = data.n
    g = logreg_gradient_from_margins(data, b, state.Ax, state.x, l2=l2)
    g_norm = torch.sqrt(torch.dot(g.to(adt), g.to(adt)))
    if bool(g_norm < tolerance):
        return _early(state, g_norm)
    w = hessian_weights(state.Ax, data_mask(data))

    def hvp(v):
        Hv = over_n(rmatvec(data, w * spmv(data, v)), n)
        if l2:
            Hv = Hv + l2 * v
        return Hv

    def trial(reg, r0):
        return cubic_solve_cg(hvp, g, reg.to(g.dtype), r0.to(g.dtype),
                              it_max=solver_it_max, epsilon=solver_eps,
                              cg_maxiter=cg_maxiter, accum_dtype=adt)

    return _line_search(data, b, state, trial, l2, beta, ls_max, adt,
                        g_norm, reg_ceil)


class CubicNewton(Optimizer):
    """Reference class ``Cubic_LS`` (cubic.py:115-235), on the oracle's
    device."""

    def __init__(self, reg_coef=None, cubic_solver="CG", solver_it_max=100,
                 solver_eps=1e-8, beta=0.5, cg_maxiter=None, ls_max=200,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        if cubic_solver not in ("CG", "full"):
            raise ValueError(f"cubic_solver not recognized: {cubic_solver}")
        self.cubic_solver = cubic_solver
        self.solver_it_max = int(solver_it_max)
        self.solver_eps = float(solver_eps)
        self.beta = float(beta)
        self.cg_maxiter = cg_maxiter
        self.ls_max = int(ls_max)
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        self._graphs: _FullGraphs | None = None

    def init_state(self, x0, seed):
        state = initial_state(self.loss, x0, self.reg_coef, CRNState)
        self.loss.reset()
        self.trace.solver_its = [0]
        return state

    def _step_graphs(self):
        """The instance's "full" step graphs on one card, else None: the
        CPU runs eagerly, and "CG" keeps its host loop."""
        if (self.cubic_solver != "full" or not self.state.x.is_cuda
                or not isinstance(self.loss.data, DualSparse)):
            return None
        if self._graphs is None:
            self._graphs = _FullGraphs(self.state.x.device)
        return self._graphs

    def step(self):
        kw = dict(
            l2=self.loss.l2, beta=self.beta, solver_eps=self.solver_eps,
            solver_it_max=self.solver_it_max, tolerance=float(self.tolerance),
            ls_max=self.ls_max,
            accum_dtype=accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )
        if self.cubic_solver == "full":
            reads0 = read_resolved.count
            graphs = self._step_graphs()
            if graphs is not None:
                kw["adt"] = kw.pop("accum_dtype")
                self.state = graphs.step(self.loss.data, self.loss.b_t,
                                         self.state, kw)
            else:
                self.state = crn_step_full(self.loss.data, self.loss.b_t,
                                           self.state, **kw)
            # the flag's reads: one a block, the first block's included
            self.trace.metrics.setdefault("ls_blocks", []).append(
                read_resolved.count - reads0 - 1)
        else:
            self.state = crn_step_cg(self.loss.data, self.loss.b_t,
                                     self.state, cg_maxiter=self.cg_maxiter,
                                     **kw)

    def check_convergence(self):
        # the reference's grad-norm exit leaves x unchanged so the
        # iterate-diff tolerance fires; also stop directly on grad norm
        if (self.tolerance > 0 and self.it > 0
                and float(self.state.grad_norm) < self.tolerance):
            return True
        return super().check_convergence()

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
