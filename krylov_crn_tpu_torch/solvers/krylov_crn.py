"""Krylov Cubic Regularized Newton in the d-space (the paper's method).

Port of ``krylov_crn_tpu/solvers/krylov_crn.py`` (reference
cubic.py:238-319). One step:

    gradient (from cached margins)                       1 A^T product
    Lanczos on the HVP operator, m steps, full reorth    m HVPs = 2m products
    tridiagonal eigh + every candidate's secular Newton  one kernel launch
    backtracking line search over L = ls_max + 1 candidate regularizations
    at once:
        steps S (L, m) and margins Ax + S @ AV (L, n)   <- AV from Lanczos
        f of every candidate from its margins            (no SpMV)
        commit the first accepted candidate, else the last (device index)
        x_new = x + s @ V                                (GEMV, chosen row)

The JAX package runs the line search as a ``lax.while_loop`` inside one
XLA program; here every candidate is evaluated at once and the committed
one is picked on the device, so the step reads nothing back to the host:
the same regularizations (reg_coef * beta, then k sequential divisions by
beta), the same accept test, and the JAX loop's rule when no candidate is
accepted (it commits its last trial). The tridiagonal eigh and the
candidates' Newton solves are one launch of ``csrc/subproblem.cu`` on a
card (``ops/subproblem.tridiag_secular``). On a card the products go
through the dense matvec kernel when the data keeps dense copies
(``ops/spmv.py``).

On one card ``CubicKrylov.step`` replays the step captured as a CUDA
graph (``utils/graphs``), on the dense branch and on the CSR branch
alike: a CSR product makes no host read once its first call in a process
has set it up, and the capture's eager warm-up step makes that call. On
the CPU and on row-sharded data the step runs eagerly. Spans
(``utils/spans``): ``krylov.init_state`` (the product and value at x0) and
``krylov.step``, which counts the matvec kernel's launches.

On row-sharded data (``parallel.sharded.ShardedDual``) x, the Lanczos
basis and every subspace quantity are replicated, while the margins ``Ax``
and the rows of ``AV`` are this rank's block: each HVP and the gradient
take one all-reduce of a d-vector, and the candidates' values one small
all-gather of every candidate's pair, so every rank picks the same one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.data.formats import DualSparse
from krylov_crn_tpu_torch.models.logistic import (
    data_mask,
    hessian_weights,
    logreg_gradient_from_margins,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.lanczos import lanczos
from krylov_crn_tpu_torch.ops.math import (
    fold,
    over_n,
    ls_accept,
    pair_diff,
    reg_clamp,
)
from krylov_crn_tpu_torch.ops.matvec import matvec
from krylov_crn_tpu_torch.ops.spmv import dense_matvec, rmatvec, spmv
from krylov_crn_tpu_torch.ops.subproblem import tridiag_secular
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers.krylov_gram import _pick
from krylov_crn_tpu_torch.utils.graphs import StepGraphs
from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["CubicKrylov", "KrylovState", "krylov_step"]


class KrylovState(NamedTuple):
    x: torch.Tensor  # iterate (d,)
    Ax: torch.Tensor  # cached margins A @ x (n,)
    value: torch.Tensor  # f(x) two-float hi part
    value_lo: torch.Tensor
    reg_coef: torch.Tensor  # current Hessian-Lipschitz estimate M
    r0: torch.Tensor  # warm-started secular root (cubic.py:255,307)
    solver_it: torch.Tensor  # accumulated 1-D Newton iterations (int64)
    diff_norm: torch.Tensor  # ||x_new - x_old|| of the last step
    grad_norm: torch.Tensor  # ||grad|| observed in the last step
    f_best: torch.Tensor  # running min of observed f (loss.py:66-73)
    f_best_lo: torch.Tensor


class Trials(NamedTuple):
    """Every line-search candidate of a step, candidate k on row k."""

    regs: torch.Tensor  # (L,) reg_coef * beta, divided by beta k times
    lams: torch.Tensor  # (L,) secular roots
    its: torch.Tensor  # (L,) their Newton iterations
    model_decs: torch.Tensor  # (L,) model decreases
    S_c: torch.Tensor  # (L, m) steps in Lanczos coordinates, storage dtype
    Axs: torch.Tensor  # (L, n) margins
    xs: torch.Tensor | None  # (L, d) iterates, only when l2 > 0
    vhis: torch.Tensor  # (L,) values, two-float pairs
    vlos: torch.Tensor


def _candidate_regs(reg_coef, beta: float, L: int):
    """The line search's L regularizations as the JAX loop makes them:
    reg_coef * beta, then each one the previous one divided by beta (k
    sequential roundings, not a power of 1/beta)."""
    regs = [reg_coef * beta]
    for _ in range(L - 1):
        regs.append(regs[-1] / beta)
    return torch.stack(regs)


def _trials(data, b, state: KrylovState, lz, g_norm, theta, Q, lams, its,
            regs, l2, vkw) -> Trials:
    """Steps, margins and values of every candidate at once."""
    cdt = state.x.dtype
    c = g_norm * Q[0, :]
    U = -c[None, :] / (theta[None, :] + lams[:, None])  # (L, m)
    S = U @ Q.T  # rows: Q @ u, the steps in Lanczos coordinates
    norm_s = torch.sqrt(torch.sum(U * U, dim=1))
    model_decs = (lams / 2.0 * norm_s ** 2 - regs / 3.0 * norm_s ** 3
                  - g_norm * S[:, 0] / 2.0)
    S_c = S.to(cdt)
    Axs = state.Ax[None, :] + S_c @ lz.aux
    # the l2 term needs every candidate's |x|^2: the L iterates, (L, d)
    xs = state.x[None, :] + S_c @ lz.V if l2 else None
    vhis, vlos = logreg_value_from_margins(
        b, Axs, xs if l2 else state.x, l2=l2, **vkw)
    return Trials(regs=regs, lams=lams, its=its, model_decs=model_decs,
                  S_c=S_c, Axs=Axs, xs=xs, vhis=vhis, vlos=vlos)


def _first_accepted(trials: Trials, state: KrylovState):
    """The index (a 1-element device tensor) the JAX loop commits: the
    first candidate that passes the accept test, else the last one."""
    ok = ls_accept(trials.vhis, trials.vlos, state.value, state.value_lo,
                   trials.model_decs)
    last = ok.shape[0] - 1
    return torch.where(ok.any(), torch.argmax(ok.to(torch.int32)),
                       last).reshape(1)


def krylov_step(
    data,
    b: torch.Tensor,
    state: KrylovState,
    m: int = 10,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    ls_max: int = 20,
    reorth_passes: int = 1,
    accum_dtype=None,
    reg_ceil: float = 1e6,
) -> KrylovState:
    """One Krylov-CRN iteration (cubic.py:265-309), with no host read
    outside the plain subproblem of CPU tensors."""
    cdt = state.x.dtype
    adt = cdt if accum_dtype is None else accum_dtype
    n = data.n

    x, Ax = state.x, state.Ax
    g = logreg_gradient_from_margins(data, b, Ax, x, l2=l2)
    w = hessian_weights(Ax, data_mask(data))
    vkw = value_args(data)

    def hvp_op(v):
        Av = spmv(data, v)
        Hv = over_n(rmatvec(data, w * Av), n)
        if l2:
            Hv = Hv + l2 * v
        return Hv, Av

    lz = lanczos(hvp_op, g, m, reorth_passes=reorth_passes, accum_dtype=adt)

    # subspace problem in accum precision: T = tridiag(alphas, betas),
    # g_sub = ||g|| e1  =>  Ritz weights c = ||g|| * Q[0, :]; every
    # candidate starts its Newton from the state's r0, as in JAX
    g_norm = torch.sqrt(torch.dot(g.to(adt), g.to(adt)))
    regs = _candidate_regs(state.reg_coef.to(adt), beta, ls_max + 1)
    theta, Q, lams, its = tridiag_secular(
        lz.alphas.to(adt), lz.betas.to(adt), g_norm, regs, state.r0.to(adt),
        xtol=solver_eps, it_max=solver_it_max)
    tr = _trials(data, b, state, lz, g_norm, theta, Q, lams, its, regs, l2,
                 vkw)
    idx = _first_accepted(tr, state)

    x_new = (_pick(tr.xs, idx) if l2
             else x + _pick(tr.S_c, idx) @ lz.V)
    vhi, vlo = _pick(tr.vhis, idx), _pick(tr.vlos, idx)
    diff = x_new - x
    diff_norm = torch.sqrt(torch.dot(diff.to(adt), diff.to(adt)))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return KrylovState(
        x=x_new,
        Ax=_pick(tr.Axs, idx),
        value=vhi,
        value_lo=vlo,
        reg_coef=reg_clamp(_pick(regs, idx), reg_ceil).to(cdt),
        r0=_pick(lams, idx).to(cdt),
        solver_it=state.solver_it + _pick(its, idx),
        diff_norm=diff_norm.to(cdt),
        grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )


krylov_step.graph_captures = 0
krylov_step.graph_replays = 0

# the step's kernels, by their Python counters (utils/graphs)
_COUNTERS = ((matvec, "launches"), (matvec, "shape_launches"),
             (dense_matvec, "cuda_calls"), (tridiag_secular, "launches"),
             (fold, "launches"))
# what a step's span counts: the dense branch's products
_STEP_COUNTS = ((matvec, "launches"),)


def _data_ptrs(data: DualSparse):
    """The addresses of every tensor of ``data`` (a graph reads them)."""
    ts = [data.at_indptr]
    for M in (data.a, data.at):
        ts += [M.crow_indices(), M.col_indices(), M.values()]
    ts += [t for t in (data.dense, data.dense_t) if t is not None]
    return tuple(t.data_ptr() for t in ts)


class _StepGraphs(StepGraphs):
    """``krylov_step`` captured as CUDA graphs for one CubicKrylov on one
    card, keyed on the step's keyword arguments (m, ls_max, l2, beta,
    solver_eps, solver_it_max, reorth_passes, the accumulation dtype,
    reg_ceil) and the data pointers of the DualSparse and the labels. A
    step is the state copied into the static buffers, one replay, and the
    new state cloned out."""

    def __init__(self, device):
        super().__init__(device, _COUNTERS,
                         (krylov_step, "graph_captures"),
                         (krylov_step, "graph_replays"))
        self.data = None

    def step(self, data: DualSparse, b, state: KrylovState,
             kw: dict) -> KrylovState:
        if self.data is not data:
            self.graphs.clear()
            self.data = data
        self.buffers(state)
        self.load(state)
        key = (tuple(sorted(kw.items())), _data_ptrs(data), b.data_ptr())
        entry = self.graphs.get(key)
        if entry is None:
            def body():
                self.load(krylov_step(data, b, self.state, **kw))

            entry = self.capture(key, body, lambda: krylov_step(
                data, b, self.clone(), **kw))
        self.replay(entry)
        return self.clone()


def _initial_value(data, b, x0, l2):
    """(value_hi, value_lo, margins) at the start point."""
    Ax = spmv(data, x0)
    hi, lo = logreg_value_from_margins(b, Ax, x0, l2=l2, **value_args(data))
    return hi, lo, Ax


def initial_state(loss, x0, reg_coef, state_cls):
    """The d-space solvers' first state at x0 on the oracle's device."""
    x0 = loss.vec(x0)
    value, value_lo, Ax = _initial_value(loss.data, loss.b_t, x0, loss.l2)
    cdt, dev = x0.dtype, x0.device
    scalar = lambda v: torch.tensor(v, dtype=cdt, device=dev)
    return state_cls(
        x=x0, Ax=Ax, value=value, value_lo=value_lo,
        reg_coef=scalar(reg_coef), r0=scalar(0.1),
        solver_it=torch.zeros((), dtype=torch.int64, device=dev),
        diff_norm=scalar(float("inf")), grad_norm=scalar(float("inf")),
        f_best=value, f_best_lo=value_lo)


class CubicKrylov(Optimizer):
    """Reference class ``Cubic_Krylov_LS`` (cubic.py:238-319), on the
    oracle's device.

    Arguments mirror the reference: reg_coef (Hessian-Lipschitz estimate;
    defaults to the oracle's), subspace_dim m, solver_eps, beta."""

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=1e-8,
                 beta=0.5, solver_it_max=100, ls_max=20, reorth_passes=1,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = float(solver_eps)
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reorth_passes = int(reorth_passes)
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        self._graphs: _StepGraphs | None = None

    def init_state(self, x0, seed):
        with span("krylov.init_state"):
            state = initial_state(self.loss, x0, self.reg_coef, KrylovState)
        self.loss.reset()
        self.trace.solver_its = [0]
        return state

    def _step_kwargs(self):
        return dict(
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def _step_graphs(self):
        """The instance's step graphs where ``step`` replays them (one
        card, one device's data), else None: the CPU runs eagerly, and
        gloo's collectives cannot be captured."""
        if (not self.state.x.is_cuda
                or not isinstance(self.loss.data, DualSparse)):
            return None
        if self._graphs is None:
            self._graphs = _StepGraphs(self.state.x.device)
        return self._graphs

    def step(self):
        with span("krylov.step", counts=_STEP_COUNTS):
            data, b, kw = self.loss.data, self.loss.b_t, self._step_kwargs()
            graphs = self._step_graphs()
            if graphs is not None:
                self.state = graphs.step(data, b, self.state, kw)
            else:
                self.state = krylov_step(data, b, self.state, **kw)

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
