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

The JAX ``while_loop`` line search becomes a Python loop with the same cap
and accept test (one host read per trial, and one per secular Newton
step). The reference forces tolerance = 0 (cubic.py:345); so does this.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.models.logistic import (
    logreg_partials,
    logreg_value_from_margins,
    value_args,
)
from krylov_crn_tpu_torch.ops.math import ls_accept, pair_diff, reg_clamp
from krylov_crn_tpu_torch.ops.subproblem import secular_newton, sym_eigh
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers.krylov_crn import _initial_value

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
    (m distinct column indices on the data's device)."""
    cdt = state.x.dtype
    adt = cdt if accum_dtype is None else accum_dtype
    x, Ax, value = state.x, state.Ax, state.value

    g, H, B = logreg_partials(data, b, Ax, x, I, l2=l2)
    theta, Q = sym_eigh(H.to(adt))
    g_a = g.to(adt)
    c = Q.T @ g_a
    r0 = state.r0.to(adt)

    def trial(reg):
        lams, its = secular_newton(theta, c, reg.reshape(1), r0,
                                   xtol=solver_eps, it_max=solver_it_max)
        lam, it = lams[0], its[0]
        u = -c / (theta + lam)
        s = Q @ u
        norm_s = torch.sqrt(torch.sum(u * u))
        model_dec = (lam / 2.0 * norm_s ** 2 - reg / 3.0 * norm_s ** 3
                     - torch.dot(g_a, s) / 2.0)
        s_c = s.to(cdt)
        # I holds distinct indices: one write per element, no accumulation
        x_new = x.index_put((I,), x[I] + s_c)
        Ax_new = Ax + B @ s_c
        vhi, vlo = logreg_value_from_margins(b, Ax_new, x_new, l2=l2,
                                             **value_args(data))
        return lam, it, model_dec, x_new, Ax_new, vhi, vlo

    # backtracking from max(reg*beta, fp64 eps) (the floor mirrors
    # cubic.py:366); every trial warm-starts from the committed r0
    reg = torch.clamp(state.reg_coef.to(adt) * beta, min=FP64_EPS)
    lam, it, model_dec, x_new, Ax_new, vhi, vlo = trial(reg)
    trials = 0
    while trials < ls_max and not bool(
            ls_accept(vhi, vlo, value, state.value_lo, model_dec)):
        reg = reg / beta
        lam, it, model_dec, x_new, Ax_new, vhi, vlo = trial(reg)
        trials += 1

    diff = (x_new - x).to(adt)
    diff_norm = torch.sqrt(torch.dot(diff, diff))
    better = pair_diff(vhi, vlo, state.f_best, state.f_best_lo) < 0
    return SSCNState(
        x=x_new, Ax=Ax_new, value=vhi, value_lo=vlo,
        reg_coef=reg_clamp(reg, reg_ceil).to(cdt),
        r0=lam.to(cdt),
        solver_it=state.solver_it + it,
        diff_norm=diff_norm.to(cdt),
        f_best=torch.where(better, vhi, state.f_best),
        f_best_lo=torch.where(better, vlo, state.f_best_lo),
    )


def draw_coordinates(generator: torch.Generator, d: int, m: int,
                     device) -> torch.Tensor:
    """m distinct coordinates of range(d) from a CPU generator, moved to
    ``device``."""
    return torch.randperm(d, generator=generator)[:m].to(device)


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

    def step(self):
        data = self.loss.data
        I = draw_coordinates(self.generator, data.d, self.subspace_dim,
                             data.device)
        self.state = sscn_step(
            data, self.loss.b_t, self.state, I,
            l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max,
            accum_dtype=accum_dtype(self.state.x.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def update_trace(self):
        super().update_trace()
        self.trace.solver_its.append(int(self.state.solver_it))
