"""Cubic-regularized subproblem:  min_s <g,s> + 1/2 <s,Hs> + M/3 ||s||^3.

Port of ``krylov_crn_tpu/ops/subproblem.py`` (the Cartis-Gould-Toint
secular-equation approach, reference cubic.py:40-75):

* **eigendecompose once, solve many**: the m x m Lanczos tridiagonal (or a
  small dense Hessian) is factored once per step, and every secular
  evaluation is then O(m) closed form. ``secular_newton`` solves the
  secular equation for a batch of regularizations at once (the JAX
  package vmaps a ``while_loop``; here the candidates form a batch axis
  with a per-candidate done mask);
* a matrix-free CG variant for the full-space CRN "CG" solver
  (cubic.py:152-182): each phi needs one CG solve, each phi' a second.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["tridiag_eigh", "secular_newton", "CubicSolution",
           "cubic_solve_eigh", "cubic_subproblem_eigh", "cubic_solve_cg"]


class CubicSolution(NamedTuple):
    s: torch.Tensor  # minimizer
    iterations: torch.Tensor  # 1-D Newton iterations used
    r: torch.Tensor  # the root lambda* (warm start for the next call)
    model_decrease: torch.Tensor  # r/2||s||^2 - M/3||s||^3 - <g,s>/2


def tridiag_eigh(alphas: torch.Tensor, betas: torch.Tensor):
    """(theta, Q) of the symmetric tridiagonal T(alphas, betas), ascending
    eigenvalues. Eigenvector signs may differ from JAX's; the solver's
    step and lambda do not depend on them."""
    T = (torch.diag(alphas) + torch.diag(betas, -1)
         + torch.diag(betas, 1))
    return torch.linalg.eigh(T)


def secular_newton(theta, c, M, r0, xtol: float = 1e-8, it_max: int = 100):
    """Newton on phi(lam) = lam^2 - M^2 * sum_i c_i^2/(theta_i+lam)^2 for a
    batch of regularizations ``M`` (shape (L,)) sharing one (theta, c).

    Returns (lam, its), both of shape (L,). Per candidate this is exactly
    the JAX package's loop: scipy-newton stopping (|step| < xtol, capped
    iterations) with the positivity/definiteness safeguard. A candidate
    that has stopped keeps its values while the others go on; the loop
    ends when none is active (one host read of that flag per Newton
    step)."""
    dt = theta.dtype
    M = torch.as_tensor(M, dtype=dt, device=theta.device)
    c2 = c * c
    nz = c2 > 0
    lo = torch.clamp(-torch.min(theta), min=0.0)
    lo_strict = torch.where(lo > 0, lo + 1e-6 * (1.0 + lo), lo)
    lam = torch.maximum(torch.as_tensor(r0, dtype=dt, device=theta.device),
                        lo_strict).expand(M.shape).clone()
    step = torch.full_like(lam, float("inf"))
    its = torch.zeros(M.shape, dtype=torch.int64, device=theta.device)
    MM = M * M
    for _ in range(it_max):
        active = (torch.abs(step) >= xtol) & (its < it_max)
        if not bool(active.any()):
            break
        # zero-weight eigenpairs drop out instead of dividing 0/0
        denom = theta[None, :] + lam[:, None]
        safe = torch.where(nz, denom, 1.0)
        s2 = torch.where(nz, c2 / (safe * safe), 0.0).sum(-1)
        s3 = torch.where(nz, c2 / (safe * safe * safe), 0.0).sum(-1)
        phi = lam * lam - MM * s2
        dphi = 2.0 * lam + 2.0 * MM * s3
        lam_new = lam - phi / dphi
        # bisection-style safeguard: never cross the pole
        lam_new = torch.where(lam_new <= lo, (lam + lo) / 2.0, lam_new)
        step = torch.where(active, lam_new - lam, step)
        lam = torch.where(active, lam_new, lam)
        its = its + active.to(its.dtype)
    return lam, its


def cubic_solve_eigh(theta, Q, g, M, r0, xtol: float = 1e-8,
                     it_max: int = 100) -> CubicSolution:
    """Solve the cubic subproblem given a ready eigendecomposition of H."""
    dt = theta.dtype
    M = torch.as_tensor(M, dtype=dt, device=theta.device)
    c = Q.T @ g.to(dt)
    lam, it = secular_newton(theta, c, M.reshape(1), r0, xtol=xtol,
                             it_max=it_max)
    lam, it = lam[0], it[0]
    cz = c != 0
    u = torch.where(cz, -c / torch.where(cz, theta + lam, 1.0), 0.0)
    s = Q @ u
    norm_s = torch.sqrt(torch.sum(u * u))
    model_decrease = (lam / 2.0 * norm_s ** 2 - M / 3.0 * norm_s ** 3
                      - torch.dot(g.to(dt), s) / 2.0)
    return CubicSolution(s=s, iterations=it, r=lam,
                         model_decrease=model_decrease)


def cubic_subproblem_eigh(g, H, M, r0=0.1, xtol: float = 1e-8,
                          it_max: int = 100) -> CubicSolution:
    """Dense-H convenience wrapper (factor + solve)."""
    theta, Q = torch.linalg.eigh(H)
    return cubic_solve_eigh(theta, Q, g, M, r0, xtol=xtol, it_max=it_max)


def cubic_solve_cg(hvp: Callable, g, M, r0, it_max: int = 100,
                   epsilon: float = 1e-8, cg_maxiter: int | None = None,
                   accum_dtype=None) -> CubicSolution:
    """Matrix-free cubic solve: every secular evaluation runs a CG solve
    over HVPs (parity with reference cubic.py:152-182). ``hvp(v)`` returns
    H v without the lam*I shift. One host read per Newton step."""
    from krylov_crn_tpu_torch.ops.cg import cg_solve

    dt = g.dtype
    adt = dt if accum_dtype is None else accum_dtype
    M = torch.as_tensor(M, dtype=dt, device=g.device)

    def dot(u, v):
        return torch.dot(u.to(adt), v.to(adt))

    def solve_shifted(lam, rhs):
        x, _ = cg_solve(lambda v: hvp(v) + lam * v, rhs, rtol=epsilon,
                        maxiter=cg_maxiter, accum_dtype=adt)
        return x

    lam = torch.as_tensor(r0, dtype=dt, device=g.device)
    step = torch.full_like(lam, float("inf"))
    it = 0
    while it < it_max and bool(torch.abs(step) >= epsilon):
        s = solve_shifted(lam, -g)
        p = lam * lam - M * M * dot(s, s).to(dt)
        dp = 2.0 * lam + 2.0 * M * M * dot(s, solve_shifted(lam, s)).to(dt)
        lam_new = torch.clamp(lam - p / dp, min=0.0)
        step = lam_new - lam
        lam = lam_new
        it += 1
    s = solve_shifted(lam, -g)
    norm_s = torch.sqrt(dot(s, s)).to(dt)
    model_decrease = (lam / 2.0 * norm_s ** 2 - M / 3.0 * norm_s ** 3
                      - dot(g, s).to(dt) / 2.0)
    return CubicSolution(s=s, iterations=torch.tensor(it, device=g.device),
                         r=lam, model_decrease=model_decrease)
