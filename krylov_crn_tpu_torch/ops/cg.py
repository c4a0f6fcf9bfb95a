"""Conjugate gradient.

Port of ``krylov_crn_tpu/ops/cg.py`` (the reference's
``scipy.sparse.linalg.cg`` over HVP closures, cubic.py:157-179). The
``lax.while_loop`` becomes a Python loop with one host read of the
residual test per iteration.

Termination matches scipy's legacy semantics: ||r|| <= max(rtol*||b||,
atol), plus an iteration cap.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cg_solve"]


def cg_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
             rtol: float = 1e-5, atol: float = 0.0,
             maxiter: int | None = None, accum_dtype=None):
    """Solve ``matvec(x) = b`` for a symmetric positive-definite matvec.
    Returns (x, iterations)."""
    cdt = b.dtype
    adt = cdt if accum_dtype is None else accum_dtype
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x = torch.zeros_like(b) if x0 is None else x0

    def dot(u, v):
        return torch.dot(u.to(adt), v.to(adt))

    bnorm = torch.sqrt(dot(b, b))
    tol2 = torch.clamp(rtol * bnorm, min=atol) ** 2
    r = b - matvec(x)
    p = r
    gamma = dot(r, r)
    it = 0
    while it < maxiter and bool(gamma > tol2):
        Ap = matvec(p)
        alpha = (gamma / dot(p, Ap)).to(cdt)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = dot(r, r)
        beta = (gamma_new / gamma).to(cdt)
        p = r + beta * p
        gamma = gamma_new
        it += 1
    return x, it
