"""Stochastic Subspace Cubic Newton (coordinate version, Hanzely et al.).

Port of ``krylov_crn_tpu/solvers/sscn.py`` (reference cubic.py:321-408).
One step:

    m distinct coordinates I (drawn by the caller, see below)
    dense n x m column panel B = A[:, I]          (ops/coords.py)
    partial gradient  Bᵀ (sigma(Ax) - b) / n      (GEMV)
    partial Hessian   Bᵀ diag(w) B / n            (GEMM)
    eigendecompose the m x m Hessian once; line-search trials re-solve
        only the O(m) secular equation
    x[I] += s and the margins Ax += B @ s (the functional analogue of the
        reference's ``update_mat_vec_product``), so a value costs O(n).

The coordinates: the JAX package draws them with ``jax.random.choice``
from a key carried in the state; threefry cannot be reproduced here.
``sscn_step`` therefore takes I as an argument, and ``SSCN`` draws it from
an explicit CPU ``torch.Generator`` seeded by the run's seed
(``randperm(d)[:m]``), then moves it to the device: a card run and a CPU
run see the same coordinates. The generator's state belongs to a
checkpoint (utils/checkpoint.py), not to the state. On row-sharded data
every rank seeds its own generator alike and so draws the same I; the
panel and the margins are this rank's rows, and g_I and H_I take one
all-reduce each (``models/logistic.logreg_partials``).

The JAX package runs the step as one XLA program. Here it reads the host
once: the eigh and the candidates' Newton are the kernels ``csrc/eigh.cu``
and ``csrc/subproblem.cu`` (``eig_secular``) on a card, and the line search
runs in blocks of ``crn.LS_BLOCK`` trials as CRN "full" does
(``solvers/crn.py``), from max(reg_coef * beta, fp64 eps), each block's
margins Ax + B @ S^T in one product, the committed iterate by
``index_put`` of the chosen row. On one card ``SSCN.step`` copies the
drawn coordinates into a static buffer and replays the step captured as
a CUDA graph, and each further block as a second graph; on the CPU and on
row-sharded data it runs eagerly. The reference forces tolerance = 0
(cubic.py:345); so does this.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.data.formats import DualSparse
from krylov_crn_tpu_torch.models.logistic import (
    logreg_partials,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.eigh import sym_eigh
from krylov_crn_tpu_torch.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu_torch.ops.subproblem import eig_secular
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers import crn
from krylov_crn_tpu_torch.solvers.crn import (
    Search,
    SearchGraphs,
    block_pick,
    block_regs,
    commit,
    read_resolved,
)
from krylov_crn_tpu_torch.solvers.krylov_crn import _data_ptrs, _initial_value
from krylov_crn_tpu_torch.solvers.krylov_gram import _pick
from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["SSCN", "SSCNState", "sscn_step"]

FP64_EPS = float(np.finfo(np.float64).eps)


class SSCNState(NamedTuple):
    x: torch.Tensor
    Ax: torch.Tensor
    value: torch.Tensor  # f(x) two-float hi part
    value_lo: torch.Tensor
    reg_coef: torch.Tensor
    r0: torch.Tensor
    solver_it: torch.Tensor  # int64
    diff_norm: torch.Tensor
    f_best: torch.Tensor
    f_best_lo: torch.Tensor


class _Factor(NamedTuple):
    """What every block of an SSCN step shares."""

    I: torch.Tensor  # the coordinates
    B: torch.Tensor  # the column panel A[:, I], storage dtype
    g: torch.Tensor  # partial gradient, accumulation dtype
    theta: torch.Tensor  # eigenvalues of H_I, ascending
    Q: torch.Tensor
    c: torch.Tensor  # Q^T g


def _factor(data, b, state: SSCNState, I, l2, adt) -> _Factor:
    g, H, B = logreg_partials(data, b, state.Ax, state.x, I, l2=l2)
    theta, Q = sym_eigh(H.to(adt))
    g = g.to(adt)
    return _Factor(I=I, B=B, g=g, theta=theta, Q=Q, c=Q.T @ g)


def _block(data, b, state: SSCNState, fac: _Factor, search: Search,
           new: SSCNState, first: bool, l2, beta, solver_eps, solver_it_max,
           ls_max, adt, reg_ceil):
    """One block of ``crn.LS_BLOCK`` line-search trials
    (cubic.py:352-398's trial): every trial's Newton (one ``eig_secular``
    launch on a card), step, margins and value, the pick and its commit.
    No host read."""
    cdt = state.x.dtype
    block = crn.LS_BLOCK
    x, Ax = state.x, state.Ax
    # backtracking from max(reg*beta, fp64 eps) (the floor mirrors
    # cubic.py:366); every trial warm-starts from the committed r0
    first_reg = (torch.clamp(state.reg_coef.to(adt) * beta, min=FP64_EPS)
                 if first else search.reg / beta)
    regs = block_regs(first_reg, beta, block)
    lams, its = eig_secular(fac.theta, fac.c, regs,
                            state.r0.to(adt).reshape(1), xtol=solver_eps,
                            it_max=solver_it_max)
    U = -fac.c[None, :] / (fac.theta[None, :] + lams[:, None])
    S = U @ fac.Q.T  # rows: Q @ u
    norm_s = torch.sqrt(torch.sum(U * U, dim=1))
    model_decs = (lams / 2.0 * norm_s ** 2 - regs / 3.0 * norm_s ** 3
                  - (S @ fac.g) / 2.0)
    S_c = S.to(cdt)
    Axs = Ax[None, :] + (fac.B @ S_c.T).T
    if l2:  # the l2 term needs every candidate's iterate
        xs = x[None, :].repeat(block, 1)
        rows = torch.arange(block, device=x.device)[:, None]
        xs = xs.index_put((rows, fac.I[None, :]), x[fac.I][None, :] + S_c)
    vhis, vlos = logreg_value_from_margins(b, Axs, xs if l2 else x, l2=l2,
                                           **value_args(data))
    ok = ls_accept(vhis, vlos, state.value, state.value_lo, model_decs)
    idx, found = block_pick(ok, search, ls_max, block)
    # I holds distinct indices: one write per element, no accumulation
    x_new = x.index_put((fac.I,), x[fac.I] + _pick(S_c, idx))
    vhi, vlo = _pick(vhis, idx), _pick(vlos, idx)
    lam = _pick(lams, idx)
    diff = (x_new - x).to(adt)
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    done = SSCNState(
        x=x_new, Ax=_pick(Axs, idx), value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(_pick(regs, idx), reg_ceil).to(cdt),
        r0=lam.to(cdt),
        solver_it=state.solver_it + _pick(its, idx),
        diff_norm=torch.sqrt(torch.dot(diff, diff)).to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )
    return commit(new, done, found, search, regs, block)


def _first(data, b, state: SSCNState, fac: _Factor, kw):
    """The first block from an unresolved search: (committed state,
    carry)."""
    dev = state.x.device
    # reg is not read: the first block starts from reg_coef
    search = Search(reg=fac.theta[0], trial=torch.zeros(
        (), dtype=torch.int64, device=dev),
        resolved=torch.zeros((), dtype=torch.bool, device=dev))
    return _block(data, b, state, fac, search, state, True, **kw)


def sscn_step(
    data,
    b: torch.Tensor,
    state: SSCNState,
    I: torch.Tensor,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = FP64_EPS,
    solver_it_max: int = 100,
    ls_max: int = 200,
    accum_dtype=None,
    reg_ceil: float = 1e6,
) -> SSCNState:
    """One SSCN iteration (cubic.py:352-398) on the coordinates ``I``
    (m distinct column indices on the data's device): blocks of
    ``crn.LS_BLOCK`` trials until the flag reads resolved (one host read per block)."""
    adt = state.x.dtype if accum_dtype is None else accum_dtype
    kw = dict(l2=l2, beta=beta, solver_eps=solver_eps,
              solver_it_max=solver_it_max, ls_max=ls_max, adt=adt,
              reg_ceil=reg_ceil)
    fac = _factor(data, b, state, I, l2, adt)
    new, search = _first(data, b, state, fac, kw)
    while not read_resolved(search):
        new, search = _block(data, b, state, fac, search, new, False, **kw)
    return new


sscn_step.graph_captures = 0
sscn_step.graph_replays = 0
sscn_step.block_replays = 0

# the counter that a step's span reads: the further blocks replayed
_STEP_COUNTS = ((sscn_step, "block_replays"),)


class _SSCNGraphs(SearchGraphs):
    """``sscn_step`` on one card, keyed on the step's keyword arguments,
    ``crn.LS_BLOCK`` and the data's and labels' addresses; the coordinates are copied into a
    static buffer of their own before each step."""

    def __init__(self, device):
        super().__init__(device, sscn_step)
        self.I = None

    def step(self, data: DualSparse, b, state: SSCNState, I, kw: dict):
        self.on(data)
        self.buffers(state)
        if self.I is None or self.I.shape != I.shape:
            self.graphs.clear()
            self.I = torch.empty(I.shape, dtype=torch.int64,
                                 device=self.device)
        self.load(state)
        self.I.copy_(I)
        key = (tuple(sorted(kw.items())), crn.LS_BLOCK, _data_ptrs(data),
               b.data_ptr())

        def first(st):
            fac = _factor(data, b, st, self.I, kw["l2"], kw["adt"])
            return (fac, *_first(data, b, st, fac, kw))

        return self.run(key, first, lambda st, fac, search, new: _block(
            data, b, st, fac, search, new, False, **kw))


def draw_coordinates(generator: torch.Generator, d: int, m: int,
                     device) -> torch.Tensor:
    """m distinct coordinates of range(d) from a CPU generator, moved to
    ``device`` (to a card from pinned memory: the copy does not wait for
    the card)."""
    cuda = torch.device(device).type == "cuda"
    # the host's part alone: the span closes before the copy
    with span("sscn.draw", host=True):
        I = torch.randperm(d, generator=generator)[:m]
        if cuda:
            I = I.pin_memory()
    return I.to(device, non_blocking=cuda)


class SSCN(Optimizer):
    """Reference class ``SSCN`` (cubic.py:321-408), on the oracle's
    device. ``self.generator`` (a CPU ``torch.Generator`` seeded by the
    run's seed) draws the coordinates."""

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=None,
                 beta=0.5, solver_it_max=100, ls_max=200, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = FP64_EPS if solver_eps is None else float(
            solver_eps)
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        # the reference zeroes the iterate-diff tolerance (cubic.py:345)
        self.tolerance = 0
        self.generator: torch.Generator | None = None
        self._graphs: _SSCNGraphs | None = None

    def init_state(self, x0, seed):
        loss = self.loss
        x0 = loss.vec(x0)
        value, value_lo, Ax = _initial_value(loss.data, loss.b_t, x0, loss.l2)
        cdt, dev = x0.dtype, x0.device
        scalar = lambda v: torch.tensor(v, dtype=cdt, device=dev)
        loss.reset()
        self.trace.solver_its = [0]
        self.generator = torch.Generator().manual_seed(int(seed))
        return SSCNState(
            x=x0, Ax=Ax, value=value, value_lo=value_lo,
            reg_coef=scalar(self.reg_coef), r0=scalar(0.1),
            solver_it=torch.zeros((), dtype=torch.int64, device=dev),
            diff_norm=scalar(float("inf")),
            f_best=value, f_best_lo=value_lo,
        )

    def _step_graphs(self):
        """The instance's step graphs on one card, else None: the CPU runs
        eagerly, and gloo's collectives cannot be captured."""
        if (not self.state.x.is_cuda
                or not isinstance(self.loss.data, DualSparse)):
            return None
        if self._graphs is None:
            self._graphs = _SSCNGraphs(self.state.x.device)
        return self._graphs

    def step(self):
        with span("sscn.step", counts=_STEP_COUNTS):
            data = self.loss.data
            kw = dict(l2=self.loss.l2, beta=self.beta,
                      solver_eps=self.solver_eps,
                      solver_it_max=self.solver_it_max, ls_max=self.ls_max,
                      reg_ceil=max(1e6, 1e4 * float(self.reg_coef)))
            adt = accum_dtype(self.state.x.dtype)
            reads0 = read_resolved.count
            I = draw_coordinates(self.generator, data.d, self.subspace_dim,
                                 data.device)
            graphs = self._step_graphs()
            if graphs is not None:
                self.state = graphs.step(data, self.loss.b_t, self.state, I,
                                         dict(kw, adt=adt))
            else:
                self.state = sscn_step(data, self.loss.b_t, self.state, I,
                                       accum_dtype=adt, **kw)
            # the flag's reads: one a block, the first block's included
            self.trace.metrics.setdefault("ls_blocks", []).append(
                read_resolved.count - reads0 - 1)

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
