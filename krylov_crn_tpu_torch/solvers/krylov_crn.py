"""Krylov Cubic Regularized Newton in the d-space (the paper's method).

Port of ``krylov_crn_tpu/solvers/krylov_crn.py`` (reference
cubic.py:238-319). One step:

    gradient (from cached margins)                       1 A^T product
    Lanczos on the HVP operator, m steps, full reorth    m HVPs = 2m products
    tridiagonal eigendecomposition (m x m)               once per step
    backtracking line search (<= ls_max + 1 trials):
        secular-equation Newton  (O(m) per trial)
        x_new  = x + s @ V        (GEMV)
        Ax_new = Ax + s @ AV      (GEMV)  <- AV collected during Lanczos
        f(x_new) from the fresh margins   (no SpMV)

The JAX package's ``while_loop`` line search becomes a Python loop with
the same cap and accept test (one host read per trial); the accepted
trial's margins become the next step's cache. On a card the products go
through the dense matvec kernel when the data keeps dense copies
(``ops/spmv.py``).

On row-sharded data (``parallel.sharded.ShardedDual``) x, the Lanczos
basis and every subspace quantity are replicated, while the margins ``Ax``
and the rows of ``AV`` are this rank's block: each HVP and the gradient
take one all-reduce of a d-vector, each trial's value one small
all-gather, and the line search reads the same booleans on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.models.logistic import (
    data_mask,
    hessian_weights,
    logreg_gradient_from_margins,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.lanczos import lanczos
from krylov_crn_tpu_torch.ops.math import (
    over_n,
    ls_accept,
    pair_diff,
    reg_clamp,
)
from krylov_crn_tpu_torch.ops.spmv import rmatvec, spmv
from krylov_crn_tpu_torch.ops.subproblem import secular_newton, tridiag_eigh
from krylov_crn_tpu_torch.solvers.base import Optimizer

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
    """One Krylov-CRN iteration (cubic.py:265-309)."""
    cdt = state.x.dtype
    adt = cdt if accum_dtype is None else accum_dtype
    n = data.n

    x, Ax, value = state.x, state.Ax, state.value
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
    AV = lz.aux  # (m, n): rows are A v_j

    # subspace problem in accum precision: T = tridiag(alphas, betas),
    # g_sub = ||g|| e1  =>  Ritz weights c = ||g|| * Q[0, :]
    theta, Q = tridiag_eigh(lz.alphas.to(adt), lz.betas.to(adt))
    g_norm = torch.sqrt(torch.dot(g.to(adt), g.to(adt)))
    c = g_norm * Q[0, :]
    r0 = state.r0.to(adt)

    def trial(reg):
        lams, its = secular_newton(theta, c, reg.reshape(1), r0,
                                   xtol=solver_eps, it_max=solver_it_max)
        lam, it = lams[0], its[0]
        u = -c / (theta + lam)
        s = Q @ u  # subspace step in Lanczos coordinates (m,)
        norm_s = torch.sqrt(torch.sum(u * u))
        model_dec = (lam / 2.0 * norm_s ** 2 - reg / 3.0 * norm_s ** 3
                     - g_norm * s[0] / 2.0)
        s_c = s.to(cdt)
        x_new = x + s_c @ lz.V
        Ax_new = Ax + s_c @ AV
        vhi, vlo = logreg_value_from_margins(b, Ax_new, x_new, l2=l2, **vkw)
        return lam, it, model_dec, x_new, Ax_new, vhi, vlo

    # backtracking (cubic.py:286-303): optimistic first trial at reg*beta,
    # then reg / beta until the two-float accept test passes, <= ls_max
    reg = state.reg_coef.to(adt) * beta
    lam, it, model_dec, x_new, Ax_new, vhi, vlo = trial(reg)
    trials = 0
    while trials < ls_max and not bool(
            ls_accept(vhi, vlo, value, state.value_lo, model_dec)):
        reg = reg / beta
        lam, it, model_dec, x_new, Ax_new, vhi, vlo = trial(reg)
        trials += 1

    diff = x_new - x
    diff_norm = torch.sqrt(torch.dot(diff.to(adt), diff.to(adt)))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return KrylovState(
        x=x_new,
        Ax=Ax_new,
        value=vhi,
        value_lo=vlo,
        reg_coef=reg_clamp(reg, reg_ceil).to(cdt),
        r0=lam.to(cdt),
        solver_it=state.solver_it + it,
        diff_norm=diff_norm.to(cdt),
        grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )


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

    def init_state(self, x0, seed):
        state = initial_state(self.loss, x0, self.reg_coef, KrylovState)
        self.loss.reset()
        self.trace.solver_its = [0]
        return state

    def step(self):
        self.state = krylov_step(
            self.loss.data, self.loss.b_t, self.state,
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
