"""The plain reference that decides ``correct``: binary logistic regression
in fp64, written from its equations with numpy, scipy and plain PyTorch.

    f(x) = mean((1 - b) * (A x) - logsig(A x)),   b in {0, 1}

It imports nothing of the program (``krylov_crn_tpu_torch``) and takes
nothing the program made: it is handed the generated (A, b, x0) and the
program's outputs, which it only judges.

* ``fstar``: the optimum for the 1e-8 target, in fp64 on the given device
  (plain PyTorch): Newton over A's numerical column space.
* ``k_rows``: rows of K = A A^T in fp64 (scipy); ``k_rows_tf32`` the same
  rows as a TF32 product computes them (the control).
* ``value_rep``: f at x = gamma * x0 + A^T zeta, the Gram solvers'
  iterate, in fp64 (``dtype=np.float32`` for the control).
* ``sscn_follow``: each SSCN step of a trajectory, worked out again in
  fp64 from the trajectory's own iterate and coordinates; ``sscn_solve``:
  a whole SSCN run in the precision of the control.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy.special import expit

__all__ = ["labels01", "loss_terms", "value", "value_rep", "fstar",
           "k_rows", "k_rows_tf32", "round_tf32", "coordinates",
           "sscn_follow", "sscn_solve", "FP32_EPS"]

FP32_EPS = float(np.finfo(np.float32).eps)
FP64_EPS = float(np.finfo(np.float64).eps)


def labels01(b) -> np.ndarray:
    """LIBSVM labels {-1, +1} as {0, 1}."""
    b = np.asarray(b, np.float64)
    return (b > 0).astype(np.float64)


def _logsig(m):
    return np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))


def loss_terms(m, b01):
    """Per-row loss at margins ``m`` (numpy, in m's dtype)."""
    return (1.0 - b01) * m - _logsig(m)


def value(A, b01, x, dtype=np.float64) -> float:
    """f(x) with every operation in ``dtype``."""
    A = A.astype(dtype)
    m = A.dot(np.asarray(x, dtype))
    return float(np.mean(loss_terms(m, b01.astype(dtype)), dtype=dtype))


def value_rep(A, b01, x0, gamma, zeta, dtype=np.float64) -> float:
    """f(gamma * x0 + A^T zeta) with every operation in ``dtype``."""
    A = A.astype(dtype)
    zeta = np.asarray(zeta, dtype)[: A.shape[0]]
    x = dtype(gamma) * np.asarray(x0, dtype) + A.T.dot(zeta)
    return value(A, b01, x, dtype)


# ------------------------------ f* --------------------------------------

def fstar(A, b, device, probes=512, rank_rtol=1e-5, tol=1e-20,
          newton_max=60):
    """min f over the margins the rows of A reach, in fp64 on ``device``.

    f depends on x only through the margins A x, and a Gram iterate's
    margins lie in A's column space. The stand-ins' rows span R = 300
    topics exactly, and A's fp32 values add a noise floor ~1e-8 below its
    largest singular value, along which the l2 = 0 loss keeps falling
    without end (it is all but separable there) at norms no solver
    reaches. So: the column space as the leading left singular vectors of
    A @ Omega (``probes`` Gaussian columns drawn with a fixed seed), those
    above ``rank_rtol`` of the largest, which must stand clear of the floor
    (the next one under ``rank_rtol`` / 100) and of ``probes``; then Newton
    over m = U y with the dense k x k Hessian, to a Newton decrement under
    ``tol``. Returns (f*, facts)."""
    import torch

    dev = torch.device(device)
    dt = torch.float64
    A = A.tocsr()
    with warnings.catch_warnings():  # torch's notes on its beta CSR format
        warnings.simplefilter("ignore", UserWarning)
        At = torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(A.data.astype(np.float64)),
            size=A.shape, dtype=dt).to(dev)
    n, d = A.shape
    probes = min(probes, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    omega = torch.randn((d, probes), generator=gen, dtype=dt, device=dev)
    U, S, _ = torch.linalg.svd(At @ omega, full_matrices=False)
    del omega
    ratio = (S / S[0]).cpu().numpy()
    k = int((ratio > rank_rtol).sum())
    floor = float(ratio[k]) if k < len(ratio) else 0.0
    if k >= probes - 8 or floor > rank_rtol / 100:
        raise RuntimeError(f"fstar: no clear rank: {k} of {probes} singular "
                           f"values above {rank_rtol}, the next at {floor}")
    U = U[:, :k].contiguous()
    b01 = torch.from_numpy(labels01(b)).to(dev)

    def f_of(m):
        ls = torch.where(m < 0, m - torch.log1p(torch.exp(m)),
                         -torch.log1p(torch.exp(-m)))
        return float(torch.mean((1.0 - b01) * m - ls))

    y = torch.zeros(k, dtype=dt, device=dev)
    m = U @ y
    f = f_of(m)
    for newton in range(newton_max):
        s = torch.sigmoid(m)
        g = U.T @ ((s - b01) / n)
        H = U.T @ ((s * (1.0 - s) / n)[:, None] * U)
        step = -torch.linalg.solve(H, g)
        dec = -float(g @ step)
        if dec < tol:
            break
        t = 1.0
        while True:
            y_new = y + t * step
            m_new = U @ y_new
            f_new = f_of(m_new)
            if f_new <= f - 1e-4 * t * dec or t < 1e-12:
                break
            t *= 0.5
        y, m, f = y_new, m_new, f_new
    else:
        raise RuntimeError(f"fstar: no convergence in {newton_max} Newton "
                           f"steps (decrement {dec:.3e})")
    return f, {"rank": k, "sv_ratio_last": float(ratio[k - 1]),
               "sv_ratio_floor": floor, "newton": newton, "decrement": dec}


# ------------------------------ K = A A^T --------------------------------

def k_rows(A, rows) -> np.ndarray:
    """Rows ``rows`` of K = A A^T in fp64, shape (len(rows), n)."""
    A64 = A.astype(np.float64).tocsr()
    return (A64[rows] @ A64.T).toarray()


def round_tf32(a) -> np.ndarray:
    """fp32 values rounded to TF32's 10-bit mantissa, to nearest even: a
    TF32 product rounds its inputs so and accumulates in fp32."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def k_rows_tf32(A, rows) -> np.ndarray:
    """Rows of K as a TF32 GEMM makes them: inputs rounded to TF32, the
    products summed in fp32."""
    At = A.astype(np.float32).tocsr(copy=True)
    At.data = round_tf32(At.data)
    return (At[rows] @ At.T).toarray().astype(np.float64)


# ------------------------------ SSCN -------------------------------------

def coordinates(seed: int, d: int, m: int, steps: int):
    """The coordinates of an SSCN run seeded with ``seed``: ``steps``
    draws of randperm(d)[:m] from one CPU torch generator, as the run's
    caller specifies them (plain torch)."""
    import torch

    gen = torch.Generator().manual_seed(int(seed))
    return [torch.randperm(d, generator=gen)[:m].numpy() for _ in
            range(steps)]


def _secular(theta, c, reg, lo):
    """The root lam >= lo of lam = reg * ||c / (theta + lam)|| (zero-weight
    pairs dropped), by bisection to the last bit of the arrays' dtype."""
    nz = c != 0
    if not nz.any():
        return lo
    th, cc = theta[nz], c[nz]
    one = theta.dtype.type(1)

    def h(lam):
        return lam - reg * np.sqrt(np.sum((cc / (th + lam)) ** 2))

    a = lo
    bnd = lo * 2 + one
    while h(bnd) < 0:
        bnd = bnd + bnd
    for _ in range(400):
        mid = (a + bnd) / 2
        if mid <= a or mid >= bnd:
            break
        if h(mid) < 0:
            a = mid
        else:
            bnd = mid
    return bnd


class _Step:
    """What one SSCN step shares over its trials, in ``dtype``: the
    margins, value, sampled gradient and Hessian's eigenpairs on the
    columns of the sample that hold entries (the others have g = 0 and a
    zero Hessian row, so their step is 0)."""

    def __init__(self, A_csc, b01, x, I, dtype, tf32):
        """``A_csc`` in ``dtype``; ``tf32``: the products' inputs rounded
        to TF32."""
        n = A_csc.shape[0]
        self.dtype = dtype
        self.m = A_csc.dot(x.astype(dtype)).astype(dtype)
        self.b01 = b01.astype(dtype)
        self.f = np.mean(loss_terms(self.m, self.b01), dtype=dtype)
        B = A_csc[:, I].astype(dtype)
        self.active = np.flatnonzero(B.getnnz(axis=0) > 0)
        Ba = B[:, self.active].tocsc()
        if tf32:
            Ba = Ba.copy()
            Ba.data = round_tf32(Ba.data).astype(dtype)
        self.B = Ba
        sig = expit(self.m).astype(dtype)
        w = (sig * (1 - sig)).astype(dtype)
        resid = (sig - self.b01).astype(dtype)
        if tf32:
            w, resid = round_tf32(w), round_tf32(resid)
        self.g = (Ba.T.dot(resid) / dtype(n)).astype(dtype)
        H = Ba.T.dot(Ba.multiply(w[:, None]).tocsc()).toarray()
        H = (np.asarray(H, dtype) / dtype(n)).astype(dtype)
        if H.size:
            self.theta, self.Q = np.linalg.eigh(H)
            self.theta = self.theta.astype(dtype)
            self.Q = self.Q.astype(dtype)
        else:
            self.theta = np.zeros(0, dtype)
            self.Q = np.zeros((0, 0), dtype)
        self.c = (self.Q.T @ self.g).astype(dtype)
        self.lo = float(max(0.0, -float(self.theta.min()))) if \
            self.theta.size else 0.0
        self.n = n

    def trial(self, reg):
        """(s on the active columns, model decrease, f at x + s)."""
        dt = self.dtype
        lam = _secular(self.theta, self.c, dt(reg), dt(self.lo))
        u = (-self.c / (self.theta + lam)).astype(dt) if self.c.size else \
            np.zeros(0, dt)
        s = (self.Q @ u).astype(dt)
        ns = dt(np.sqrt(np.sum(u * u)))
        md = dt(lam / 2 * ns * ns - dt(reg) / 3 * ns ** 3
                - dt(s @ self.g) / 2)
        m_new = (self.m + self.B.dot(s)).astype(dt)
        f_new = np.mean(loss_terms(m_new, self.b01), dtype=dt)
        return s, float(md), float(f_new)


def _accepts(gap, md, f, ulp_eps):
    return gap <= -md or (md <= ulp_eps * abs(f) and gap <= 0)


def sscn_follow(A, b, xs, coords, reg_coef, beta=0.5, ls_max=200,
                amb_rel=1e-3, amb_abs=1e-6, steps=None):
    """Each step x_k -> x_{k+1} of an fp32 SSCN trajectory ``xs`` ((K+1,
    d)), worked out again in fp64 from x_k and the step's coordinates.

    A step's trials follow the run's rule: regularizations max(reg * beta,
    fp64 eps) / beta^j, each trial's cubic step from the eigenpairs of the
    sampled Hessian and its secular root, the first trial whose decrease
    meets the model's (or, below one fp32 ulp of f, does not raise f),
    else trial ``ls_max``. A decision within ``amb_rel`` of the model
    decrease plus ``amb_abs`` |f| is a tie that fp32 may break either way,
    so either trial of a tie counts as the rule's. The next step's
    regularization is that of the trial the trajectory took (the one that
    fits it best).

    Returns the worst over the steps of |f(x_{k+1}) - f(x_k + s)| / |f(x_k)|,
    f in fp64 and s the rule's step: where the step lands, in loss. Not the
    step itself: the regularization halves at every accepted step down to
    ~1e-16, and the sampled Hessians of the stand-ins have eigenvalues at
    zero, so a step's length along those directions is ill-conditioned
    (fp32 steps 1e4 times the fp64 one's length land on the same loss to
    1e-8). ``steps``, where given, receives each step's readings."""
    A_csc = A.astype(np.float64).tocsc()
    b01 = labels01(b)
    xs = np.asarray(xs, np.float32)
    reg = float(reg_coef)
    reg_ceil = max(1e6, 1e4 * float(reg_coef))
    worst = 0.0
    for k, I in enumerate(coords):
        x = xs[k].astype(np.float64)
        x_next = xs[k + 1].astype(np.float64)
        outside = x_next - x
        outside[np.asarray(I)] = 0.0
        st = _Step(A_csc, b01, x, np.asarray(I), np.float64, False)
        f = float(st.f)
        f_next = float(np.mean(loss_terms(A_csc.dot(x_next), b01)))
        r = max(reg * beta, FP64_EPS)
        fits = []
        for j in range(ls_max + 1):
            _, md, f_new = st.trial(r)
            gap = f_new - f
            tie = abs(gap + md) <= amb_rel * max(abs(md), abs(gap)) + \
                amb_abs * abs(f) or (
                abs(md - FP32_EPS * abs(f)) <= amb_rel * FP32_EPS * abs(f)
                and gap <= 0)
            acc = _accepts(gap, md, f, FP32_EPS)
            if acc or tie or j == ls_max:
                fits.append((abs(f_next - f_new) / abs(f), r, j))
            if (acc and not tie) or j == ls_max:
                break
            r = r / beta
        err, r_taken, j = min(fits)
        if np.any(outside != 0):  # a coordinate outside the sample moved
            err = float("inf")
        if steps is not None:
            steps.append(dict(k=k, f=f, f_next=f_next, err=err, trial=j,
                              reg=r_taken, active=len(st.active),
                              ties=len(fits)))
        worst = max(worst, err)
        reg = min(r_taken, reg_ceil)
    return worst


def sscn_solve(A, b, x0, coords, reg_coef, beta=0.5, ls_max=200,
               dtype=np.float32, tf32=True):
    """A whole SSCN run in ``dtype`` (TF32 products where ``tf32``) on the
    given coordinates, from x0: the iterates, shape (K+1, d). The
    control's run in the program's place."""
    A_csc = A.astype(dtype).tocsc()
    b01 = labels01(b)
    x = np.asarray(x0, dtype).copy()
    xs = [x.copy()]
    reg = float(reg_coef)
    reg_ceil = max(1e6, 1e4 * float(reg_coef))
    eps = float(np.finfo(dtype).eps)
    for I in coords:
        I = np.asarray(I)
        st = _Step(A_csc, b01, x, I, dtype, tf32)
        r = max(reg * beta, FP64_EPS)
        for j in range(ls_max + 1):
            s, md, f_new = st.trial(r)
            if _accepts(f_new - float(st.f), md, float(st.f), eps) or \
                    j == ls_max:
                break
            r = r / beta
        x = x.copy()
        x[I[st.active]] = (x[I[st.active]] + s).astype(dtype)
        xs.append(x.copy())
        reg = min(r, reg_ceil)
    return np.stack(xs)
