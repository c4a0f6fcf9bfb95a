"""Logistic-regression oracle.

    f(x)  = mean((1-b) * Ax - logsig(Ax)) + l2/2 ||x||^2
    g(x)  = A^T (sigma(Ax) - b) / n + l2 x
    H(x)  = A^T diag(w) A / n + l2 I,   w = sigma(Ax) (1 - sigma(Ax))
    Hv    = A^T (w * (A v)) / n + l2 v          (never materializes H)

Port of ``krylov_crn_tpu/models/logistic.py``. Two layers, as there:

* a **functional core** of module-level functions on the ``DualSparse``
  data; the d-space solvers thread the margins ``Ax`` through their state;
* the **class** with the reference's oracle surface (``value`` with the
  running-best f_opt, ``gradient``, ``hessian``, ``hess_vec_prod``, the
  ``mat_vec_product`` cache, ``reset``) and the smoothness constants.

The class also keeps the host scipy matrix ``A_host`` and the labels as a
host array ``b``: the Gram solver builds K and evaluates exact values from
them and never touches the device data, which is built lazily on first
use of ``.data`` on the oracle's ``device``.

Row-sharded data (``parallel.sharded.ShardedDual``): margins, labels and
the row mask are this rank's block, x and every d-vector are replicated.
Sums over rows then cross the ranks, one collective each: the value's
two-float pair (the ranks' pairs gathered and folded in rank order, so an
fp32 value is the same bits on every rank and on every run), the
gradient's and the HVP's d-vector (inside ``rmatvec``), SSCN's g_I and
H_I, and the row-norm maximum. Padding rows are masked out everywhere
(sigma(0) - 0 = 0.5 and w(0) = 0.25 would otherwise pollute the sums).

Reductions accumulate in the storage dtype: compensated two-float pairs
in fp32 (``ops/math.py``), fp64 in fp64 runs.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch.config import as_torch_dtype, resolve_device
from krylov_crn_tpu_torch.data.formats import DualSparse, build_dual
from krylov_crn_tpu_torch.data.libsvm import canonicalize_labels
from krylov_crn_tpu_torch.models.base import Oracle
from krylov_crn_tpu_torch.ops.coords import gather_columns_dense
from krylov_crn_tpu_torch.ops.math import (
    accum_dot,
    accum_sum_pair,
    div_n,
    over_n,
    logsig,
    sigmoid,
    two_sum,
)
from krylov_crn_tpu_torch.ops.spmv import (
    hvp_sparse,
    rmatvec,
    row_sqnorms,
    spmv,
)
from krylov_crn_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
)
from krylov_crn_tpu_torch.parallel.sharded import (
    ShardedDual,
    pad_rowvec,
    sharded_gather_columns,
    sharded_row_sqnorms,
)

__all__ = ["LogisticRegression", "data_mask", "value_args",
           "logreg_value_from_margins",
           "logreg_value", "logreg_gradient_from_margins",
           "logreg_gradient", "hessian_weights", "logreg_hvp",
           "logreg_hessian_dense", "logreg_partials"]


# ------------------------------ functional core ------------------------------

def data_mask(data):
    """Row-validity mask of a padded sharded layout; None on one device."""
    return getattr(data, "mask", None)


def value_args(data) -> dict:
    """``logreg_value_from_margins``'s keywords for ``data``: the row mask
    and the mesh of sharded data, and the global row count."""
    return dict(mask=data_mask(data), n=data.n,
                mesh=getattr(data, "mesh", None))


def _fold_pairs(mesh, hi, lo):
    """The sum of every rank's two-float pair: one all-gather of the
    pairs, then a two-sum fold in rank order, the same arithmetic on the
    same bytes on every rank."""
    pairs = all_gather_rows(mesh, torch.stack([hi, lo]).reshape(1, 2))
    hi, lo = pairs[0, 0], pairs[0, 1]
    for r in range(1, pairs.shape[0]):
        hi, e = two_sum(hi, pairs[r, 0])
        lo = lo + pairs[r, 1] + e
    return hi, lo


def logreg_value_from_margins(b, Ax, x, l2: float = 0.0, mask=None,
                              n: int | None = None, mesh=None):
    """f from cached margins as a two-float (hi, lo) pair. Terms are
    scaled by 1/n before the reduction, so per-term rounding enters at
    eps*|term|/n; in fp64 the pair is a compensated fp64 sum.

    ``mask`` and ``n`` handle padded sharded rows (padding would otherwise
    add -logsig(0) = log 2 each; ``n`` is the global row count, never the
    block's). With a ``mesh`` of several ranks the margins are this rank's
    block and the ranks' pairs are folded into the global value."""
    adt = Ax.dtype
    terms = (1.0 - b) * Ax - logsig(Ax)
    if mask is not None:
        terms = terms * mask
    if n is None:
        n = Ax.shape[0]
    # divided truly, unlike the JAX package's product (over_n): a value
    # reading is held against f*, and the product would scale every term
    # by fl(1/n) * n
    terms = div_n(terms.to(adt), n)
    hi, lo = accum_sum_pair(terms, adt)
    if mesh is not None and mesh.distributed:
        hi, lo = _fold_pairs(mesh, hi, lo)
    if l2:
        t = (l2 / 2.0) * accum_dot(x, x, adt).to(adt)
        hi, e = two_sum(hi, t)
        lo = lo + e
    return hi, lo


def logreg_value(data, b, x, l2: float = 0.0):
    """(f(x), Ax)."""
    Ax = spmv(data, x)
    hi, lo = logreg_value_from_margins(b, Ax, x, l2, **value_args(data))
    return hi + lo, Ax


def logreg_gradient_from_margins(data, b, Ax, x, l2: float = 0.0):
    residual = sigmoid(Ax) - b
    mask = data_mask(data)
    if mask is not None:
        residual = residual * mask
    g = over_n(rmatvec(data, residual), data.n)
    if l2:
        g = g + l2 * x
    return g


def logreg_gradient(data, b, x, l2: float = 0.0):
    """(g(x), Ax)."""
    Ax = spmv(data, x)
    return logreg_gradient_from_margins(data, b, Ax, x, l2), Ax


def hessian_weights(Ax, mask=None):
    a = sigmoid(Ax)
    w = a * (1.0 - a)
    if mask is not None:
        w = w * mask
    return w


def logreg_hvp(data, Ax, v, l2: float = 0.0):
    """Exact HVP from cached margins (two products; loss.py:289-302)."""
    return hvp_sparse(data, hessian_weights(Ax, data_mask(data)), v, l2=l2)


def logreg_hessian_dense(data: DualSparse, Ax, l2: float = 0.0):
    """Dense Hessian for the small-d "full" solver (loss.py:249-255);
    needs the dense copy of A."""
    if data.dense is None:
        raise ValueError("dense Hessian requires DualSparse built with "
                         "want_dense=True (small-d problems)")
    w = hessian_weights(Ax)
    H = over_n((data.dense * w[:, None]).T @ data.dense, data.n)
    if l2:
        H = H + l2 * torch.eye(data.d, dtype=H.dtype, device=H.device)
    return H


def logreg_partials(data, b, Ax, x, I, l2: float = 0.0,
                    k_pad: int | None = None):
    """Coordinate-subspace gradient, Hessian and column panel for SSCN:
    (g_I, H_I, B) with B = dense A[:, I] (ops/coords.py) and

        g_I = Bᵀ (sigma(Ax) - b) / n + l2 x_I        (loss.py:234-247)
        H_I = Bᵀ diag(w) B / n + l2 I_m              (loss.py:257-264)

    B stays in the storage dtype; the products are plain matmuls, as XLA
    computes them in the JAX package.

    Row-sharded data: the panel assembles from this rank's block with no
    collective (``sharded_gather_columns``) and stays row-sharded; the two
    B^T reductions then take one all-reduce each."""
    if isinstance(data, ShardedDual):
        B = sharded_gather_columns(data, I)
        residual = (sigmoid(Ax) - b) * data.mask
        w = hessian_weights(Ax, data.mask)
        g = over_n(all_reduce_sum(data.mesh, B.T @ residual), data.n)
        H = over_n(all_reduce_sum(data.mesh, (B * w[:, None]).T @ B), data.n)
    else:
        B = gather_columns_dense(data, I, k_pad)
        residual = sigmoid(Ax) - b
        w = hessian_weights(Ax)
        g = over_n(B.T @ residual, data.n)
        H = over_n((B * w[:, None]).T @ B, data.n)
    if l2:
        g = g + l2 * x[I]
        H = H + l2 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return g, H, B


def _sigma_max(normal, v, tol: float = 1e-12, it_max: int = 10000) -> float:
    """Largest singular value of A by power iteration on the normal
    operator ``normal(v) = A^T A v`` from the unit vector ``v`` (a host
    numpy array or a tensor on the data's device), stopping when the
    Rayleigh quotient sigma^2 changes by less than ``tol`` relative."""
    norm = torch.linalg.norm if torch.is_tensor(v) else np.linalg.norm
    sig2_prev = 0.0
    for _ in range(it_max):
        w = normal(v)
        sig2 = float(norm(w))
        v = w / sig2
        if abs(sig2 - sig2_prev) <= tol * max(sig2, 1e-300):
            break
        sig2_prev = sig2
    return float(np.sqrt(sig2))


# ---------------------------------- class -----------------------------------

class LogisticRegression(Oracle):
    """The reference's logistic oracle over the functional core."""

    def __init__(self, A, b, dtype=np.float32, device=None,
                 store_mat_vec_prod=True, want_dense=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._data = None
        self._b_t = None
        self.mesh = None
        if isinstance(A, ShardedDual):
            # distributed oracle: this rank's row block, with its dtype and
            # device, and the padded row-sharded labels. A tensor of the
            # block's height (parallel.multihost.load_sharded_libsvm makes
            # one) is taken as it is: no rank holds the whole label vector
            # then. Anything else is the global label vector.
            self.dtype = np.dtype(str(A.dtype).removeprefix("torch."))
            self.device = A.device
            self.mesh = A.mesh
            self.A_host = None
            self._data = A
            if torch.is_tensor(b) and b.shape[0] == A.n_local:
                self._b_t = b.to(A.device, A.dtype)
            else:
                self._b_t = pad_rowvec(canonicalize_labels(np.asarray(b)), A)
            self.b = self._b_t.cpu().numpy()
            self.n, self.dim = A.shape
        else:
            self.dtype = np.dtype(dtype)
            self.device = resolve_device(device)
            self.A_host = (A.tocsr() if sp.issparse(A)
                           else sp.csr_matrix(np.asarray(A)))
            self.b = canonicalize_labels(np.asarray(b)).astype(self.dtype)
            self.n, self.dim = map(int, self.A_host.shape)
        self.store_mat_vec_prod = store_mat_vec_prod
        self._want_dense = want_dense
        self.reset()

    @property
    def data(self):
        """Device data (A, A^T and the small-d dense copies, or this
        rank's ``ShardedDual``), built on first use."""
        if self._data is None:
            self._data = build_dual(self.A_host, dtype=self.dtype,
                                    device=self.device,
                                    want_dense=self._want_dense)
        return self._data

    @data.setter
    def data(self, value):
        """Share another oracle's device data (same A, dtype and device)
        instead of building a second copy."""
        if value.shape != (self.n, self.dim):
            raise ValueError(f"shared data has shape {value.shape}, this "
                             f"oracle {(self.n, self.dim)}")
        self._data = value

    @property
    def b_t(self) -> torch.Tensor:
        """The labels as a tensor on the oracle's device."""
        if self._b_t is None:
            self._b_t = torch.from_numpy(self.b).to(self.device)
        return self._b_t

    def vec(self, x) -> torch.Tensor:
        """``x`` as a tensor of the oracle's dtype on its device."""
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.to(self.device, as_torch_dtype(self.dtype))

    # ---- margins cache (parity with loss.py:266-286) ----
    def mat_vec_product(self, x):
        x = self.vec(x)
        if self.store_mat_vec_prod and (
            self.reuse or (self.x_last is not None and (
                x is self.x_last or self.is_equal(x, self.x_last)))
        ):
            return self._mat_vec_prod
        Ax = spmv(self.data, x)
        if self.store_mat_vec_prod:
            self._mat_vec_prod = Ax
            self.x_last = x
        return Ax

    def update_mat_vec_product(self, Ax, delta, I):
        """Incremental margin update Ax += A[:, I] @ delta
        (loss.py:279-281); the next margins read reuses it."""
        I = torch.as_tensor(I, dtype=torch.int64, device=self.device)
        data = self.data
        B = (sharded_gather_columns(data, I) if isinstance(data, ShardedDual)
             else gather_columns_dense(data, I))
        self._mat_vec_prod = self.vec(Ax) + B @ self.vec(delta)
        self.reuse = True

    def reset(self):
        self.reuse = False
        self.x_last = None
        self._mat_vec_prod = None

    # ---- oracle surface ----
    def _value(self, x):
        x = self.vec(x)
        Ax = self.mat_vec_product(x)
        hi, lo = logreg_value_from_margins(self.b_t, Ax, x, l2=self.l2,
                                           **value_args(self.data))
        # the pair combined on the host: full precision in fp32 runs too
        return float(hi) + float(lo)

    def gradient(self, x):
        x = self.vec(x)
        Ax = self.mat_vec_product(x)
        return logreg_gradient_from_margins(self.data, self.b_t, Ax, x,
                                            l2=self.l2)

    def hessian(self, x):
        Ax = self.mat_vec_product(x)
        return logreg_hessian_dense(self.data, Ax, l2=self.l2)

    def hess_vec_prod(self, x, v, grad_dif=False, eps=None):
        """Exact HVP from cached margins, or the finite-difference
        gradient-difference fallback (loss.py:289-293) with
        ``grad_dif=True`` and step ``eps``."""
        x, v = self.vec(x), self.vec(v)
        if grad_dif:
            if eps is None:
                raise ValueError("grad_dif HVP requires an eps step size")
            return (self.gradient(x + eps * v) - self.gradient(x)) / eps
        Ax = self.mat_vec_product(x)
        return logreg_hvp(self.data, Ax, v, l2=self.l2)

    def _partials(self, x, I):
        x = self.vec(x)
        Ax = self.mat_vec_product(x)
        I = torch.as_tensor(I, dtype=torch.int64, device=self.device)
        return logreg_partials(self.data, self.b_t, Ax, x, I, l2=self.l2)

    def partial_gradient(self, x, I):
        return self._partials(x, I)[0]

    def partial_hessian(self, x, I):
        return self._partials(x, I)[1]

    # ---- smoothness constants (loss.py:308-347) ----
    def _row_sqnorms(self):
        data = self.data
        return (sharded_row_sqnorms(data) if isinstance(data, ShardedDual)
                else row_sqnorms(data.a))

    def _over_rows(self, reduce, collective) -> float:
        """A reduction of the per-row squared norms over all rows: local,
        then (sharded data) one collective over the ranks."""
        t = reduce(self._row_sqnorms())
        return float(t if self.mesh is None else collective(self.mesh, t))

    @property
    def smoothness(self):
        if self._smoothness is None:
            if self.dim > 20000 and self.n > 20000:
                warnings.warn(
                    "The matrix is too large to estimate the smoothness "
                    "constant, so Frobenius estimate is used instead.")
                fro2 = self._over_rows(
                    lambda r: r.to(torch.float32).sum(), all_reduce_sum)
                self._smoothness = 0.25 * fro2 / self.n + self.l2
            else:
                data = self.data
                v0 = torch.full((data.d,), 1.0 / np.sqrt(data.d),
                                dtype=data.dtype, device=data.device)
                smax = _sigma_max(lambda v: rmatvec(data, spmv(data, v)), v0)
                self._smoothness = 0.25 * smax**2 / self.n + self.l2
        return self._smoothness

    @property
    def max_smoothness(self):
        if self._max_smoothness is None:
            mx = self._over_rows(torch.max, all_reduce_max)
            self._max_smoothness = 0.25 * mx + self.l2
        return self._max_smoothness

    @property
    def average_smoothness(self):
        if self._ave_smoothness is None:
            av = self._over_rows(torch.sum, all_reduce_sum) / self.n
            self._ave_smoothness = 0.25 * av + self.l2
        return self._ave_smoothness

    @property
    def hessian_lipschitz(self):
        """||A||^2 / (6 sqrt(3) n) * max_i ||a_i||, as in the JAX package
        (reference loss.py:343-347), computed on the host in fp64 from
        ``A_host`` (the Gram path never builds the device data): the
        Frobenius estimate when both n and d exceed 20000, else the
        largest singular value by power iteration."""
        if self._hessian_lipschitz is None and self.A_host is None:
            # sharded data: no rank holds A, so from the device constants
            a_max = np.sqrt(self._over_rows(torch.max, all_reduce_max))
            self._hessian_lipschitz = (
                (self.smoothness - self.l2) * 4 * a_max / (6 * np.sqrt(3)))
        if self._hessian_lipschitz is None:
            A = self.A_host.astype(np.float64)
            row_sq = np.asarray(A.multiply(A).sum(axis=1)).ravel()
            if self.dim > 20000 and self.n > 20000:
                sq_norm = float(row_sq.sum())
            else:
                d = A.shape[1]
                sq_norm = _sigma_max(lambda v: A.T @ (A @ v),
                                     np.full(d, 1.0 / np.sqrt(d))) ** 2
            a_max = float(np.sqrt(row_sq.max()))
            self._hessian_lipschitz = (sq_norm / self.n) * a_max \
                / (6 * np.sqrt(3))
        return self._hessian_lipschitz

    @staticmethod
    def density(x):
        x = np.asarray(x)
        return 0.0 if x.size == 0 else float((x != 0).sum()) / x.size
