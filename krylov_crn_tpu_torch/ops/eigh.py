"""Dense symmetric eigendecomposition on the card: ``csrc/eigh.cu``.

The JAX package's CRN "full" and SSCN steps call ``jnp.linalg.eigh`` on the
d x d Hessian (``krylov_crn_tpu/solvers/crn.py:105``) or the m x m
coordinate Hessian (``solvers/sscn.py:92``) inside one XLA program. In
PyTorch the same call is cuSOLVER, whose ``info`` PyTorch checks on the
host, so a step that contains it can neither run ahead of the host nor be
captured as a CUDA graph. The hand-written kernel reads nothing back:

* ``sym_eigh``: (theta ascending, Q) of a symmetric n x n H read from its
  lower triangle. CPU tensors take ``sym_eigh_plain`` (LAPACK's ``evd``
  through scipy, the library the JAX package's CPU eigh calls); CUDA
  tensors one launch of the kernel, or an error;
* ``sym_eigh_emulated``: the kernel's own walk in numpy, each operation
  rounded on its own as the kernel (built with ``--fmad=false``) rounds
  it, so the kernel's results are its bits.

The kernel is a parallel two-sided cyclic Jacobi. n is padded to an even
N with one decoupled row (zero off-diagonal) where n is odd; a sweep is
N - 1 rounds of the round-robin tournament, each round rotating N / 2
disjoint pairs (p, q) at once:

    A <- J^T A J,  V <- V J,   J = [[c, s], [-s, c]] on (p, q),

with (c, s) from a_pp, a_qq, a_pq (Golub and Van Loan's sym.schur2; a
pair with a_pq = 0 is not rotated, so exact zeros stay exact and the pad
row never moves). Before the first sweep and after each one, off(A)^2 =
sum_{i != j} a_ij^2 is held against (EPS_FACTOR eps)^2 ||A||_F^2, both
sums in a fixed order; after ``MAX_SWEEPS`` sweeps without meeting it
every theta is NaN. The diagonal is then sorted ascending (a stable rank
by value, then index) and the pad dropped by index.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["sym_eigh", "sym_eigh_plain", "sym_eigh_emulated", "MAX_N",
           "MAX_SWEEPS", "EPS_FACTOR"]

MAX_N = 2048  # csrc/eigh.cu: the largest matrix
MAX_SWEEPS = 60  # csrc/eigh.cu: Jacobi sweeps before the result is NaN
EPS_FACTOR = 4  # csrc/eigh.cu: off(A) <= EPS_FACTOR eps ||A||_F
# csrc/eigh.cu: |tau| beyond which t = 1 / (2 tau) (tau^2 would overflow)
TAU_BIG = {np.float32: 1e18, np.float64: 1e150}


def sym_eigh_plain(H: torch.Tensor):
    """(theta, Q) of a dense symmetric H on the CPU, read from its lower
    triangle, ascending: LAPACK's ``dsyevd``/``ssyevd`` through scipy, the
    library the JAX package's CPU ``eigh`` calls. torch's CPU build calls
    MKL's, whose multithreaded divide-and-conquer fails to converge on
    SSCN Hessians whose sampled columns are mostly empty (446 exact zero
    rows of 500 on rcv1-like), where scipy's and a one-thread MKL call
    both succeed."""
    import scipy.linalg

    theta, Q = scipy.linalg.eigh(H.numpy(), lower=True, driver="evd")
    return torch.from_numpy(theta), torch.from_numpy(Q)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("eigh")
        for fn in (lib.sym_eigh_f32, lib.sym_eigh_f64):
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] + [
                ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        for fn in (lib.sym_eigh_max_n, lib.sym_eigh_max_sweeps,
                   lib.sym_eigh_eps_factor):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.sym_eigh_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sym_eigh_workspace.restype = ctypes.c_longlong
        if (lib.sym_eigh_max_n() != MAX_N
                or lib.sym_eigh_max_sweeps() != MAX_SWEEPS
                or lib.sym_eigh_eps_factor() != EPS_FACTOR):
            raise RuntimeError("csrc/eigh.cu limits disagree with MAX_N / "
                               "MAX_SWEEPS / EPS_FACTOR")
        _lib = lib
    return _lib


def sym_eigh(H: torch.Tensor, sweeps: torch.Tensor | None = None):
    """(theta, Q) of a dense symmetric H (lower triangle), ascending.

    CPU tensors: ``sym_eigh_plain``. CUDA tensors (fp32 or fp64, n <=
    MAX_N): one launch of ``csrc/eigh.cu``, which reads nothing back to the
    host, or an error. Where given, ``sweeps`` (an int32 CUDA tensor of
    one element) receives the Jacobi sweeps the kernel ran. Within a
    repeated eigenvalue any orthonormal basis is right, so Q may differ
    from LAPACK's there; the cubic step built from it does not."""
    if H.device.type == "cpu":
        return sym_eigh_plain(H)
    if not H.is_cuda:
        raise ValueError(f"sym_eigh: H on {H.device}, not a CUDA device")
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sym_eigh: fp32 or fp64, got {H.dtype}")
    if H.dim() != 2 or H.shape[0] != H.shape[1] or not H.is_contiguous():
        raise ValueError(f"sym_eigh: a contiguous square matrix, got "
                         f"{tuple(H.shape)}")
    n = H.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"sym_eigh: n = {n} (at most {MAX_N})")
    lib = _library()
    dev, dt = H.device, H.dtype
    theta = torch.empty(n, dtype=dt, device=dev)
    Q = torch.empty((n, n), dtype=dt, device=dev)
    if sweeps is None:
        sweeps = torch.empty(1, dtype=torch.int32, device=dev)
    elif not (sweeps.is_cuda and sweeps.dtype == torch.int32
              and sweeps.numel() == 1):
        raise ValueError("sym_eigh: sweeps must be one int32 on the card")
    itemsize = H.element_size()
    work = torch.empty(lib.sym_eigh_workspace(n, itemsize),
                       dtype=torch.uint8, device=dev)
    fn = lib.sym_eigh_f32 if dt == torch.float32 else lib.sym_eigh_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(H.data_ptr(), n, theta.data_ptr(), Q.data_ptr(),
                 sweeps.data_ptr(), work.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sym_eigh kernel launch failed: CUDA error {err}")
    sym_eigh.launches += 1
    return theta, Q


sym_eigh.launches = 0


def tournament(N: int, r: int):
    """Round ``r`` (0 <= r < N - 1) of the round-robin tournament on N
    (even) indices: the N / 2 pairs as arrays (p, q), p < q, pair k as the
    kernel's item k makes it."""
    k = np.arange(1, N // 2)
    a = np.concatenate([[N - 1], (r + k) % (N - 1)])
    b = np.concatenate([[r], (r - k + (N - 1)) % (N - 1)])
    return np.minimum(a, b), np.maximum(a, b)


def _ordered_rowsums(A, T, off: bool):
    """Per row, sum_j a_ij^2 (j != i when ``off``) in index order, then
    the row sums added in row order: the kernel's two loops."""
    N = A.shape[0]
    rs = np.zeros(N, T)
    for j in range(N):
        sq = A[:, j] * A[:, j]
        if off:
            sq[j] = T(0)  # the kernel skips j == i; adding +0 is the same
        rs = rs + sq
    total = T(0)
    for i in range(N):
        total = total + rs[i]
    return total


def sym_eigh_emulated(H):
    """``csrc/eigh.cu``'s algorithm in numpy arrays of H's dtype (float32
    or float64), each operation rounded on its own: the same (theta, Q)
    bit for bit, as numpy arrays, and the sweeps it ran
    (``sym_eigh_emulated.sweeps``). H is read from its lower triangle."""
    H = np.asarray(H)
    if H.dtype not in (np.float32, np.float64):
        raise TypeError(f"fp32 or fp64 only, got {H.dtype}")
    T = H.dtype.type
    n = H.shape[0]
    N = n + (n & 1)
    A = np.zeros((N, N), T)
    low = np.tril(H)
    A[:n, :n] = low + np.tril(H, -1).T  # a_ij = H[max(i, j), min(i, j)]
    V = np.eye(N, dtype=T)
    tol = T(EPS_FACTOR) * T(np.finfo(T).eps)
    tau_big = T(TAU_BIG[T])
    two, half, one = T(2), T(0.5), T(1)
    with np.errstate(all="ignore"):
        fro2 = _ordered_rowsums(A, T, off=False)
        bound = (tol * tol) * fro2
        sweeps = 0
        converged = _ordered_rowsums(A, T, off=True) <= bound
        while not converged and sweeps < MAX_SWEEPS:
            for r in range(N - 1):
                P, Qi = tournament(N, r)
                app, aqq, apq = A[P, P], A[Qi, Qi], A[P, Qi]
                rot = apq != 0
                sapq = np.where(rot, apq, one)
                tau = (aqq - app) / (two * sapq)
                atau = np.abs(tau)
                sgn = np.where(tau >= 0, one, -one)
                t_small = sgn / (atau + np.sqrt(one + tau * tau))
                t_big = half / tau
                t = np.where(atau > tau_big, t_big, t_small)
                t = np.where(rot, t, T(0))
                c = one / np.sqrt(one + t * t)
                s = t * c
                tau_r = s / (one + c)
                # off-diagonal blocks: rows by J^T, then columns by J, each
                # pair as x_p - s (x_q + tau_r x_p), x_q + s (x_p - tau_r x_q)
                B11, B12 = A[np.ix_(P, P)], A[np.ix_(P, Qi)]
                B21, B22 = A[np.ix_(Qi, P)], A[np.ix_(Qi, Qi)]
                su, ru = s[:, None], tau_r[:, None]
                X11 = B11 - su * (B21 + ru * B11)
                X12 = B12 - su * (B22 + ru * B12)
                X21 = B21 + su * (B11 - ru * B21)
                X22 = B22 + su * (B12 - ru * B22)
                sv, rv = s[None, :], tau_r[None, :]
                Y11 = X11 - sv * (X12 + rv * X11)
                Y12 = X12 + sv * (X11 - rv * X12)
                Y21 = X21 - sv * (X22 + rv * X21)
                Y22 = X22 + sv * (X21 - rv * X22)
                An = np.empty_like(A)
                h = N // 2
                iu, iv = np.triu_indices(h, 1)
                for Y, R, C in ((Y11, P, P), (Y12, P, Qi), (Y21, Qi, P),
                                (Y22, Qi, Qi)):
                    y = Y[iu, iv]
                    An[R[iu], C[iv]] = y
                    An[C[iv], R[iu]] = y
                # diagonal blocks: the pivots' closed form
                tp = t * apq
                An[P, P] = np.where(rot, app - tp, app)
                An[Qi, Qi] = np.where(rot, aqq + tp, aqq)
                An[P, Qi] = T(0)
                An[Qi, P] = T(0)
                A = An
                Vp, Vq = V[:, P], V[:, Qi]
                V[:, P] = Vp - sv * (Vq + rv * Vp)
                V[:, Qi] = Vq + sv * (Vp - rv * Vq)
            sweeps += 1
            converged = _ordered_rowsums(A, T, off=True) <= bound
        d = np.diagonal(A)[:n].copy()
        if converged:
            less = (d[None, :] < d[:, None]).sum(axis=1)
            idx = np.arange(n)
            tie = ((d[None, :] == d[:, None])
                   & (idx[None, :] < idx[:, None])).sum(axis=1)
            rank = less + tie
            theta = np.empty(n, T)
            Q = np.empty((n, n), T)
            theta[rank] = d
            Q[:, rank] = V[:n, :n]
        else:
            theta = np.full(n, np.nan, T)
            Q = V[:n, :n].copy()
    sym_eigh_emulated.sweeps = sweeps
    return theta, Q


sym_eigh_emulated.sweeps = 0
