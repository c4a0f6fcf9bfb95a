"""The plain reference of one d-space Krylov CRN step (the paper's method,
Jiang et al., AISTATS 2024; the reference's ``Cubic_Krylov_LS``,
cubic.py:238-319), written from its equations with numpy and scipy.

    f(x) = mean((1 - b) * (A x) - logsig(A x)),    b in {0, 1}
    g    = A^T (sigma(A x) - b) / n
    H v  = A^T (w * (A v)) / n,                    w = sigma (1 - sigma)

A step from x with the regularization M carried from the last step:

1. m Lanczos steps on v -> H v from g / ||g||, each new vector
   reorthogonalized against every earlier one: the basis V (k, d) and the
   k x k tridiagonal T (k = m unless a residual norm falls under 1e-6);
2. T = Q diag(theta) Q^T, and the gradient's Ritz weights c = ||g|| Q[0, :];
3. L = ``ls_max`` + 1 candidate regularizations, M beta and then each the
   one before divided by beta; for each, the secular root lam = r ||u||
   with u = -c / (theta + lam), the step s = V^T Q u, and the model
   decrease lam / 2 ||u||^2 - r / 3 ||u||^3 - ||g|| (Q u)_0 / 2;
4. a candidate is accepted when f(x + s) - f(x) <= -(model decrease), or,
   once the model decrease is under one ulp of f in the program's
   precision, when f does not rise; the first accepted is committed, else
   the last; the next M is its r, capped at max(1e6, 1e4 M_0).

It imports nothing of the program (``krylov_crn_tpu_torch``) and takes
nothing the program made but the iterates it judges.

* ``dspace_follow``: each step of a trajectory worked out again in fp64
  from the trajectory's own iterate;
* ``dspace_solve``: a whole run in the precision of the control, fp32
  with TF32 products.

Departures from the paper's code, each the program's too: the Lanczos
basis is fully reorthogonalized (the paper's recurrence is plain), the
line search evaluates all L candidates and commits the first accepted (the
paper's loop tries them in turn, which commits the same one), the accept
test has the ulp clause, and the regularization has the cap. Departure
from the program: each secular root is bisected to the last bit where the
program's Newton stops at a step under ``solver_eps``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp

from benchmark.reference import (
    FP32_EPS,
    _accepts,
    _secular,
    labels01,
    loss_terms,
    round_tf32,
)

__all__ = ["BREAKDOWN", "Products", "dspace_step", "dspace_follow",
           "dspace_solve"]

BREAKDOWN = 1e-6  # the Lanczos residual norm that ends the basis (cubic.py:98)


class Products:
    """The products through A in ``dtype``. ``margins(x)``, the margins a
    value is taken from, is A x as scipy computes it in ``dtype``; ``mv``
    and ``rmv``, the products that build the step (the gradient, the
    Hessian-vector products and the Lanczos basis's A v), are the same in
    fp64 and, with ``tf32``, as a TF32 product makes them: A's values and
    the vector rounded to a 10-bit mantissa, the products summed in
    fp32."""

    def __init__(self, A, dtype=np.float64, tf32=False):
        self.A = sp.csr_matrix(A, dtype=dtype)
        A_r = self.A.copy()
        if tf32:
            A_r.data = round_tf32(A_r.data).astype(dtype)
        self.A_r, self.At_r = A_r, A_r.T.tocsr()
        self.dtype, self.tf32 = dtype, tf32
        self.n = A_r.shape[0]

    def _in(self, v):
        v = np.asarray(v, self.dtype)
        return round_tf32(v).astype(self.dtype) if self.tf32 else v

    def margins(self, x):
        return self.A.dot(np.asarray(x, self.dtype)).astype(self.dtype)

    def mv(self, v):
        return self.A_r.dot(self._in(v)).astype(self.dtype)

    def rmv(self, z):
        return self.At_r.dot(self._in(z)).astype(self.dtype)


def _value(m, b01):
    return np.mean(loss_terms(m, b01), dtype=m.dtype)


def _sigmoid(m):
    return (1.0 / (1.0 + np.exp(-m))).astype(m.dtype)


def _lanczos(hvp, g, m, dtype):
    """(V (k, d), AV (k, n), alphas (k,), betas (k - 1,)): m steps from g /
    ||g|| with full reorthogonalization (one classical Gram-Schmidt pass
    against every earlier vector); ``hvp(v)`` is (H v, A v)."""
    g_norm = np.sqrt(np.dot(g, g))
    V = [(g / g_norm if g_norm > 0 else g).astype(dtype)]
    AV, alphas, betas = [], [], []
    for j in range(m):
        w, Av = hvp(V[j])
        AV.append(Av)
        w = w - (betas[-1] * V[j - 1] if j else 0)
        alphas.append(np.dot(V[j], w))
        if j == m - 1:
            break
        w = w - alphas[-1] * V[j]
        B = np.stack(V)
        w = (w - (B @ w) @ B).astype(dtype)
        beta = np.sqrt(np.dot(w, w))
        if beta < BREAKDOWN:
            break
        betas.append(beta)
        V.append((w / beta).astype(dtype))
    return (np.stack(V), np.stack(AV), np.asarray(alphas, dtype),
            np.asarray(betas, dtype))


def dspace_step(prod: Products, b01, x, reg, m=10, beta=0.5, ls_max=20,
                ulp_eps=FP32_EPS):
    """Every candidate of one step from x with the carried regularization
    ``reg``, in ``prod``'s dtype. Returns a dict: ``f`` at x; per candidate
    ``regs``, ``x`` (L, d) and ``f_c`` (L,); and ``pick``, the index the
    rule with ``ulp_eps`` commits. A candidate's margins are A x + (A V^T)
    S, as the program forms them."""
    dt = prod.dtype
    x = np.asarray(x, dt)
    b01 = np.asarray(b01, dt)
    n = dt(prod.n)
    margins = prod.margins(x)
    f = _value(margins, b01)
    s = _sigmoid(margins)
    g = (prod.rmv(s - b01) / n).astype(dt)
    w = (s * (1 - s)).astype(dt)

    def hvp(v):
        Av = prod.mv(v)
        return (prod.rmv(w * Av) / n).astype(dt), Av

    V, AV, alphas, betas = _lanczos(hvp, g, m, dt)
    theta, Q = scipy.linalg.eigh_tridiagonal(alphas, betas)
    g_norm = dt(np.sqrt(np.dot(g, g)))
    c = (g_norm * Q[0, :]).astype(dt)
    lo = dt(max(0.0, -float(theta.min())))
    regs = [dt(reg) * dt(beta)]
    for _ in range(ls_max):
        regs.append(regs[-1] / dt(beta))
    Ss, mds = [], []
    for r in regs:
        lam = _secular(theta, c, r, lo)
        u = (-c / (theta + lam)).astype(dt)
        Ss.append((Q @ u).astype(dt))
        nu = np.sqrt(np.dot(u, u))
        mds.append(lam / 2 * nu * nu - r / 3 * nu ** 3
                   - g_norm * Ss[-1][0] / 2)
    S = np.stack(Ss)
    xs = (x[None, :] + S @ V).astype(dt)
    fs = np.asarray([_value(mc, b01) for mc in
                     (margins[None, :] + S @ AV).astype(dt)])
    mds = np.asarray(mds, dt)
    accepted = np.asarray([_accepts(fc - f, md, f, ulp_eps)
                           for fc, md in zip(fs, mds)])
    pick = int(np.argmax(accepted)) if accepted.any() else ls_max
    return dict(f=float(f), regs=np.asarray(regs, np.float64), x=xs,
                f_c=fs.astype(np.float64), pick=pick)


def _reg_ceil(reg_coef):
    return max(1e6, 1e4 * float(reg_coef))


def dspace_follow(A, b, xs, reg_coef, m=10, beta=0.5, ls_max=20,
                  ulp_eps=FP32_EPS, steps=None):
    """Each step x_k -> x_{k+1} of a trajectory ``xs`` ((K+1, d)), worked
    out again in fp64 from x_k by the rule (``dspace_step``).

    The regularization each step starts from is that of the candidate
    nearest the trajectory's own next iterate, so that the rule follows
    the regularizations the trajectory carried. Returns the worst over the
    steps of |f(x_{k+1}) - f(x_k + s_k)| / f(x_k), f in fp64 and s_k the
    rule's step: where the step lands, in loss. Not the step itself: where f
    is flat, an fp32 line search commits other regularizations than the
    fp64 rule, with steps of other lengths, and lands on the same value to
    ~1e-15. ``steps``, where given, receives each step's readings."""
    prod = Products(A)
    b01 = labels01(b)
    xs = np.asarray(xs)
    reg = float(reg_coef)
    ceil = _reg_ceil(reg_coef)
    worst = 0.0
    for k in range(len(xs) - 1):
        st = dspace_step(prod, b01, xs[k].astype(np.float64), reg, m=m,
                         beta=beta, ls_max=ls_max, ulp_eps=ulp_eps)
        x_next = xs[k + 1].astype(np.float64)
        f_next = float(_value(prod.mv(x_next), b01))
        err = abs(f_next - st["f_c"][st["pick"]]) / abs(st["f"])
        near = int(np.argmin(np.linalg.norm(st["x"] - x_next, axis=1)))
        if steps is not None:
            steps.append(dict(k=k, f=st["f"], f_next=f_next, err=err,
                              pick=st["pick"], nearest=near,
                              reg=float(st["regs"][near])))
        worst = max(worst, err)
        reg = min(float(st["regs"][near]), ceil)
    return worst


def dspace_solve(A, b, x0, reg_coef, m=10, beta=0.5, ls_max=20, it_max=48,
                 tolerance=1e-9, dtype=np.float32, tf32=True):
    """A whole run in ``dtype`` (TF32 products where ``tf32``) from x0,
    stopped as the program's run loop stops it: after ``it_max`` steps, or
    after a step shorter than ``tolerance``. Returns the iterates, shape
    (K+1, d): the control's run in the program's place."""
    prod = Products(A, dtype, tf32)
    b01 = labels01(b)
    eps = float(np.finfo(dtype).eps)
    x = np.asarray(x0, dtype)
    xs = [x]
    reg = float(reg_coef)
    ceil = _reg_ceil(reg_coef)
    for _ in range(int(it_max)):
        st = dspace_step(prod, b01, x, reg, m=m, beta=beta, ls_max=ls_max,
                         ulp_eps=eps)
        x_new = st["x"][st["pick"]]
        reg = min(float(st["regs"][st["pick"]]), ceil)
        diff = float(np.linalg.norm((x_new - x).astype(np.float64)))
        x = x_new
        xs.append(x)
        if diff < tolerance:
            break
    return np.stack(xs)
