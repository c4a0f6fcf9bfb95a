"""Lanczos tridiagonalization with a fixed subspace dimension.

Port of ``krylov_crn_tpu/ops/lanczos.py`` (there a ``lax.scan``; here a
Python loop of m - 1 steps with no host read):

* static ``m`` with *breakdown masking*: on breakdown (beta < tol,
  reference cubic.py:98) the remaining basis rows stay zero, the step
  stops advancing, and ``k`` records the valid count; masked rows carry
  zero Ritz weight downstream;
* optional full reorthogonalization (classical Gram-Schmidt passes
  against all stored rows; unfilled rows are zero);
* the operator returns ``(H v, aux)`` and the auxes are stacked: the
  logistic solver passes ``aux = A v`` and gets AV (m x n), which turns
  every line-search trial into a GEMV instead of a fresh SpMV. The final
  aux goes to row k - 1 so AV's rows stay matched to V's after a
  breakdown.

Inner products accumulate in ``accum_dtype``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["lanczos", "LanczosResult"]


class LanczosResult(NamedTuple):
    alphas: torch.Tensor  # (m,) diagonal of T, masked entries zero
    betas: torch.Tensor  # (m-1,) off-diagonal, masked entries zero
    V: torch.Tensor  # (m, d) basis rows, masked rows zero
    k: torch.Tensor  # 0-d int64: number of valid basis vectors
    beta_last: torch.Tensor  # final residual norm (reference's `beta`)
    aux: torch.Tensor | None  # stacked per-step operator aux, leading dim m


def _dot(x, y, adt):
    return torch.dot(x.to(adt), y.to(adt))


def lanczos(op: Callable, g: torch.Tensor, m: int, reorth_passes: int = 1,
            breakdown_tol: float = 1e-6, accum_dtype=None) -> LanczosResult:
    """Tridiagonalize the operator on the Krylov space K_m(op, g);
    ``op(v) -> (H v, aux)`` with aux a tensor or None."""
    d = g.shape[0]
    cdt, dev = g.dtype, g.device
    adt = cdt if accum_dtype is None else accum_dtype
    zero = torch.zeros((), dtype=cdt, device=dev)

    g_norm = torch.sqrt(_dot(g, g, adt)).to(cdt)
    # numerically-zero gradient (exact convergence): zero basis, not NaNs
    v = g / torch.where(g_norm > 0, g_norm, 1.0)
    V = torch.zeros((m, d), dtype=cdt, device=dev)
    V[0] = v
    v_prev = torch.zeros_like(v)
    beta_prev = zero
    active = torch.ones((), dtype=torch.bool, device=dev)
    k = torch.ones((), dtype=torch.int64, device=dev)
    alphas, betas, auxs = [], [], []
    for j in range(m - 1):
        Hv, aux = op(v)
        w = Hv - beta_prev * v_prev
        alpha = _dot(v, w, adt).to(cdt)
        alphas.append(torch.where(active, alpha, zero))
        w = w - alpha * v
        for _ in range(reorth_passes):
            coeffs = (V.to(adt) @ w.to(adt)).to(cdt)
            w = w - coeffs @ V
        beta = torch.sqrt(_dot(w, w, adt)).to(cdt)
        ok = torch.abs(beta) >= breakdown_tol
        proceed = active & ok
        beta_prev = torch.where(proceed, beta, zero)
        betas.append(beta_prev)
        v_next = torch.where(proceed, w / torch.where(ok, beta, 1.0), v)
        v_prev = torch.where(proceed, v, v_prev)
        V[j + 1] = torch.where(proceed, v_next, V[j + 1])
        k = torch.where(proceed, j + 2, k)
        active = proceed
        v = v_next
        auxs.append(aux)

    # final exact diagonal entry on the last valid vector
    # (reference cubic.py:109: alphas[-1] = <v, A v>)
    Hv, aux_last = op(v)
    alpha_last = _dot(v, Hv, adt).to(cdt)
    slot = torch.arange(m, device=dev) == k - 1
    alphas = torch.stack(alphas + [zero])
    alphas = torch.where(slot, alpha_last, alphas)
    betas = (torch.stack(betas) if betas
             else torch.zeros(0, dtype=cdt, device=dev))
    aux = None
    if aux_last is not None:
        # the m-th aux goes to the last valid slot, so AV matches V's rows
        aux = torch.stack(auxs + [torch.zeros_like(aux_last)])
        aux = torch.where(slot[:, None], aux_last[None, :], aux)
    return LanczosResult(alphas=alphas, betas=betas, V=V, k=k,
                         beta_last=beta_prev, aux=aux)
