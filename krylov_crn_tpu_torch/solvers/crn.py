"""Full-space Cubic Regularized Newton with line search (Nesterov-Polyak).

Port of ``krylov_crn_tpu/solvers/crn.py`` (reference cubic.py:115-235).
Two subproblem backends, the reference's switch (cubic_newton.py:76-82):

* ``"full"`` (small d): the dense Hessian, eigendecomposed once per step;
  every secular evaluation of every line-search trial is then O(d);
* ``"CG"`` (large d): matrix-free, every secular evaluation is a CG solve
  over HVPs (the reference's Newton x CG x SpMV nest, cubic.py:152-182).

The gradient-norm early exit (cubic.py:201-202) zeroes the step so the
run loop's iterate-diff tolerance fires, as in the reference. The JAX
package's ``lax.cond`` and ``while_loop`` become Python control flow with
one host read per decision. The ``"CG"`` backend also runs on row-sharded
data (``parallel.sharded.ShardedDual``), one all-reduce per HVP; ``"full"``
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
from krylov_crn_tpu_torch.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu_torch.ops.spmv import rmatvec, spmv
from krylov_crn_tpu_torch.ops.subproblem import (
    cubic_solve_cg,
    cubic_solve_eigh,
    sym_eigh,
)
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers.krylov_crn import initial_state

__all__ = ["CubicNewton", "CRNState", "crn_step_full", "crn_step_cg"]


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

    cdt = state.x.dtype
    diff = x_new - state.x
    diff_norm = torch.sqrt(torch.dot(diff.to(adt), diff.to(adt)))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return CRNState(
        x=x_new, Ax=Ax_new, value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(reg, reg_ceil).to(cdt),
        r0=sol.r.to(cdt),
        solver_it=state.solver_it + sol.iterations,
        diff_norm=diff_norm.to(cdt), grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )


def _early(state, g_norm):
    return state._replace(diff_norm=torch.zeros_like(state.diff_norm),
                          grad_norm=g_norm.to(state.x.dtype))


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
    """One CRN iteration with the dense-eigh subproblem backend."""
    adt = state.x.dtype if accum_dtype is None else accum_dtype
    g = logreg_gradient_from_margins(data, b, state.Ax, state.x, l2=l2)
    g_norm = torch.sqrt(torch.dot(g.to(adt), g.to(adt)))
    if bool(g_norm < tolerance):
        return _early(state, g_norm)
    H = logreg_hessian_dense(data, state.Ax, l2=l2).to(adt)
    theta, Q = sym_eigh(H)  # factor once; O(d) per trial after

    def trial(reg, r0):
        return cubic_solve_eigh(theta, Q, g.to(adt), reg, r0,
                                xtol=solver_eps, it_max=solver_it_max)

    return _line_search(data, b, state, trial, l2, beta, ls_max, adt,
                        g_norm, reg_ceil)


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
        Hv = rmatvec(data, w * spmv(data, v)) / n
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

    def init_state(self, x0, seed):
        state = initial_state(self.loss, x0, self.reg_coef, CRNState)
        self.loss.reset()
        self.trace.solver_its = [0]
        return state

    def step(self):
        kw = dict(
            l2=self.loss.l2, beta=self.beta, solver_eps=self.solver_eps,
            solver_it_max=self.solver_it_max, tolerance=float(self.tolerance),
            ls_max=self.ls_max,
            accum_dtype=accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )
        if self.cubic_solver == "full":
            self.state = crn_step_full(self.loss.data, self.loss.b_t,
                                       self.state, **kw)
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
