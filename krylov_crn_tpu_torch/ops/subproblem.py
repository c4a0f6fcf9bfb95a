"""Cubic-regularized subproblem:  min_s <g,s> + 1/2 <s,Hs> + M/3 ||s||^3.

Port of ``krylov_crn_tpu/ops/subproblem.py`` (the Cartis-Gould-Toint
secular-equation approach, reference cubic.py:40-75):

* **eigendecompose once, solve many**: the m x m Lanczos tridiagonal (or a
  small dense Hessian) is factored once per step, and every secular
  evaluation is then O(m) closed form. ``secular_newton`` solves the
  secular equation for a batch of regularizations at once (the JAX
  package vmaps a ``while_loop``; here the candidates form a batch axis
  with a per-candidate done mask);
* ``tridiag_secular``: the tridiagonal eigen-solve and the batched Newton
  of one Gram Krylov step in one launch of the hand-written kernel
  ``csrc/subproblem.cu`` on a card, with no host read (the JAX step's
  ``tridiag_eigh`` and vmapped ``secular_newton``, which XLA runs on the
  device). ``tridiag_secular_plain`` is the same function from the two
  pieces above (the CPU's path), and ``tridiag_secular_emulated`` the
  kernel's own scalar algorithm in numpy, bit for bit;
* a matrix-free CG variant for the full-space CRN "CG" solver
  (cubic.py:152-182): each phi needs one CG solve, each phi' a second.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["sym_eigh", "tridiag_eigh", "secular_newton", "tridiag_secular",
           "tridiag_secular_plain", "tridiag_secular_emulated",
           "CubicSolution", "cubic_solve_eigh", "cubic_subproblem_eigh",
           "cubic_solve_cg"]

MAX_M = 64  # csrc/subproblem.cu: the largest tridiagonal
MAX_CANDIDATES = 64  # csrc/subproblem.cu: threads of its one block
QL_MAX_SWEEPS = 60  # csrc/subproblem.cu: QL sweeps per eigenvalue


def sym_eigh(H: torch.Tensor):
    """(theta, Q) of a dense symmetric H (lower triangle), ascending.

    On a card this is cuSOLVER through ``torch.linalg.eigh``. On the CPU it
    is LAPACK's ``dsyevd``/``ssyevd`` through scipy, the library the JAX
    package's CPU ``eigh`` calls: torch's CPU build calls MKL's, whose
    multithreaded divide-and-conquer fails to converge on SSCN Hessians
    whose sampled columns are mostly empty (446 exact zero rows of 500 on
    rcv1-like), where scipy's and a one-thread MKL call both succeed."""
    if H.device.type != "cpu":
        return torch.linalg.eigh(H)
    import scipy.linalg

    theta, Q = scipy.linalg.eigh(H.numpy(), lower=True, driver="evd")
    return torch.from_numpy(theta), torch.from_numpy(Q)


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


def tridiag_secular_plain(alphas, betas, g_norm, regs, r0,
                          xtol: float = 1e-8, it_max: int = 100):
    """(theta, Q, lams, its) of one Gram Krylov step in plain PyTorch:
    ``tridiag_eigh`` of T(alphas, betas), c = g_norm * Q[0, :], then
    ``secular_newton`` over the candidate regularizations ``regs``."""
    theta, Q = tridiag_eigh(alphas, betas)
    c = g_norm * Q[0, :]
    lams, its = secular_newton(theta, c, regs, r0, xtol=xtol, it_max=it_max)
    return theta, Q, lams, its


_lib = None


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("subproblem")
        for fn in (lib.tridiag_secular_f32, lib.tridiag_secular_f64):
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_double] + [ctypes.c_int] * 3 + [
                ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        for fn in (lib.tridiag_secular_max_m,
                   lib.tridiag_secular_max_candidates):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if (lib.tridiag_secular_max_m() != MAX_M
                or lib.tridiag_secular_max_candidates() != MAX_CANDIDATES):
            raise RuntimeError("csrc/subproblem.cu limits disagree with "
                               "MAX_M / MAX_CANDIDATES")
        _lib = lib
    return _lib


def _check(alphas, betas, g_norm, regs, r0):
    ts = dict(alphas=alphas, betas=betas, g_norm=g_norm, regs=regs, r0=r0)
    dev, dt = alphas.device, alphas.dtype
    for name, t in ts.items():
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"tridiag_secular: {name} ({t.device}) must lie "
                             f"on alphas' CUDA device ({dev})")
        if t.dtype != dt or dt not in (torch.float32, torch.float64):
            raise TypeError(f"tridiag_secular: fp32 or fp64 throughout, got "
                            f"{name} {t.dtype} beside alphas {dt}")
        if not t.is_contiguous():
            raise ValueError(f"tridiag_secular: {name} must be contiguous")
    m, L = alphas.numel(), regs.numel()
    if (alphas.dim() != 1 or betas.shape != (m - 1,) or regs.dim() != 1
            or g_norm.numel() != 1 or r0.numel() != 1):
        raise ValueError(f"tridiag_secular: alphas (m,), betas (m-1,), regs "
                         f"(L,) and one-element g_norm and r0, got "
                         f"{tuple(alphas.shape)}, {tuple(betas.shape)}, "
                         f"{tuple(regs.shape)}, {tuple(g_norm.shape)}, "
                         f"{tuple(r0.shape)}")
    if not (1 <= m <= MAX_M and 1 <= L <= MAX_CANDIDATES):
        raise ValueError(f"tridiag_secular: m = {m} (at most {MAX_M}) and "
                         f"L = {L} (at most {MAX_CANDIDATES})")


def tridiag_secular(alphas, betas, g_norm, regs, r0, xtol: float = 1e-8,
                    it_max: int = 100):
    """(theta, Q, lams, its): the eigendecomposition of the tridiagonal
    T(alphas, betas), ascending, and the secular Newton roots ``lams``
    with their iteration counts for every candidate regularization in
    ``regs`` (shape (L,)), with c = g_norm * Q[0, :] and the warm start
    ``r0``.

    CPU tensors: ``tridiag_secular_plain``. CUDA tensors (fp32 or fp64,
    m <= MAX_M, L <= MAX_CANDIDATES): one launch of ``csrc/subproblem.cu``,
    which reads nothing back to the host, or an error. Eigenvector signs
    may differ between the two; the steps built from them do not."""
    if all(t.device.type == "cpu" for t in (alphas, betas, g_norm, regs,
                                            r0)):
        return tridiag_secular_plain(alphas, betas, g_norm, regs, r0,
                                     xtol=xtol, it_max=it_max)
    _check(alphas, betas, g_norm, regs, r0)
    lib = _library()
    m, L = alphas.numel(), regs.numel()
    dt, dev = alphas.dtype, alphas.device
    theta = torch.empty(m, dtype=dt, device=dev)
    Q = torch.empty((m, m), dtype=dt, device=dev)
    lams = torch.empty(L, dtype=dt, device=dev)
    its = torch.empty(L, dtype=torch.int64, device=dev)
    fn = (lib.tridiag_secular_f32 if dt == torch.float32
          else lib.tridiag_secular_f64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(alphas.data_ptr(), betas.data_ptr(), g_norm.data_ptr(),
                 regs.data_ptr(), r0.data_ptr(), float(xtol), int(it_max), m,
                 L, theta.data_ptr(), Q.data_ptr(), lams.data_ptr(),
                 its.data_ptr(), stream)
    if err:
        raise RuntimeError(f"tridiag_secular kernel launch failed: CUDA "
                           f"error {err}")
    tridiag_secular.launches += 1
    return theta, Q, lams, its


tridiag_secular.launches = 0


def _radius(a, b, T):
    """sqrt(a^2 + b^2) as the kernel takes it (``radius``)."""
    absa, absb = abs(a), abs(b)
    if absa > absb:
        p = absb / absa
        return absa * np.sqrt(T(1) + p * p)
    if absb == 0:
        return T(0)
    p = absa / absb
    return absb * np.sqrt(T(1) + p * p)


def tridiag_secular_emulated(alphas, betas, g_norm, regs, r0,
                             xtol: float = 1e-8, it_max: int = 100):
    """``csrc/subproblem.cu``'s algorithm in numpy scalars of alphas'
    dtype (float32 or float64), each operation rounded on its own as the
    kernel (built with --fmad=false) rounds it: the same (theta, Q, lams,
    its) bit for bit, as numpy arrays. Inputs are numpy arrays and
    scalars.

    Implicit-shift QL with eigenvectors (tqli; radius |a| sqrt(1 +
    (b/a)^2)), a selection sort to ascending order, then per candidate
    the secular Newton of ``secular_newton`` with the sums over the modes
    in index order. A column rotation here applies to all rows at once;
    the kernel applies a sweep's rotations row by row, in the same order,
    so every element sees the same operations."""
    alphas = np.asarray(alphas)
    T = alphas.dtype.type
    if alphas.dtype not in (np.float32, np.float64):
        raise TypeError(f"fp32 or fp64 only, got {alphas.dtype}")
    m = alphas.shape[0]
    d = alphas.astype(T).copy()
    e = np.zeros(m, T)
    e[:m - 1] = np.asarray(betas, T)
    z = np.eye(m, dtype=T)
    failed = False
    with np.errstate(all="ignore"):
        l = sweeps = rotations = 0
        while l < m:
            mm = l
            while mm < m - 1:
                dd = abs(d[mm]) + abs(d[mm + 1])
                if abs(e[mm]) + dd == dd:
                    break
                mm += 1
            if mm == l:
                l += 1
                sweeps = 0
                continue
            if sweeps == QL_MAX_SWEEPS:
                failed = True
                break
            sweeps += 1
            rotations += mm - l
            g = (d[l + 1] - d[l]) / (T(2) * e[l])
            r = _radius(g, T(1), T)
            g = d[mm] - d[l] + e[l] / (g + (abs(r) if g >= 0 else -abs(r)))
            s = c = T(1)
            p = T(0)
            i = mm - 1
            while i >= l:
                f = s * e[i]
                b = c * e[i]
                r = _radius(f, g, T)
                e[i + 1] = r
                if r == 0:
                    d[i + 1] = d[i + 1] - p
                    e[mm] = T(0)
                    break
                s = f / r
                c = g / r
                g = d[i + 1] - p
                r = (d[i] - g) * s + T(2) * c * b
                p = s * r
                d[i + 1] = g + p
                g = c * r - b
                zf = z[:, i + 1].copy()
                z[:, i + 1] = s * z[:, i] + c * zf
                z[:, i] = c * z[:, i] - s * zf
                i -= 1
            if not (r == 0 and i >= l):
                d[l] = d[l] - p
                e[l] = g
                e[mm] = T(0)

        perm = list(range(m))
        for i in range(m - 1):
            k, p = i, d[i]
            for j in range(i + 1, m):
                if d[j] < p:
                    k, p = j, d[j]
            if k != i:
                d[k] = d[i]
                d[i] = p
                perm[i], perm[k] = perm[k], perm[i]
        if failed:
            d[:] = np.nan
        theta, Q = d, z[:, perm]
        c = T(g_norm) * Q[0, :]
        c2 = c * c

        M = np.asarray(regs, T)
        MM = M * M
        mn = theta[0]
        for i in range(1, m):
            if theta[i] < mn:
                mn = theta[i]
        lo = -mn if -mn > 0 else T(0)
        lo_strict = lo + T(1e-6) * (T(1) + lo) if lo > 0 else lo
        r0 = T(r0)
        lam = np.full(M.shape, r0 if r0 >= lo_strict else lo_strict, T)
        step = np.full(M.shape, np.inf, T)
        its = np.zeros(M.shape, np.int64)
        xt = T(xtol)
        while True:
            active = (np.abs(step) >= xt) & (its < it_max)
            if not active.any():
                break
            s2 = np.zeros(M.shape, T)
            s3 = np.zeros(M.shape, T)
            for i in range(m):
                if c2[i] > 0:
                    sf = theta[i] + lam
                    sq = sf * sf
                    s2 = s2 + c2[i] / sq
                    s3 = s3 + c2[i] / (sq * sf)
            phi = lam * lam - MM * s2
            dphi = T(2) * lam + T(2) * MM * s3
            lam_new = lam - phi / dphi
            lam_new = np.where(lam_new <= lo, (lam + lo) / T(2), lam_new)
            step = np.where(active, lam_new - lam, step)
            lam = np.where(active, lam_new, lam)
            its = its + active
    tridiag_secular_emulated.rotations = rotations
    return theta, Q, lam, its


# the QL rotations of the last call, at most one sweep's full length each
# (the work a bound on the kernel's time counts)
tridiag_secular_emulated.rotations = 0


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
    theta, Q = sym_eigh(H)
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
