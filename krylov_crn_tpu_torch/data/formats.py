"""Device sparse-matrix formats for the d-space solvers.

Port of ``krylov_crn_tpu/data/formats.py``. A and its explicitly stored
transpose A^T are torch sparse CSR tensors on one device, so both
products are the same row-segment reduction and no scatter ever runs
(the JAX package's design, its docstring :13-15). ``at_indptr`` and
``max_col_nnz`` index A's columns (the rows of A^T) as in the JAX
package, for the coordinate-window gathers of SSCN.

Small-d problems also keep dense copies of A and A^T (the ``want_dense``
rule of the JAX package, n*d*itemsize <= 512 MiB and d <= 2048), so both
directions of the dense branch are the same row-major matvec
(``ops/matvec.py``). Each dense copy is a view of an (rows, ld) buffer
whose leading dimension ld is padded to a multiple of 16 bytes, so every
row starts 16-byte aligned for the kernel's vector loads (w8a's 300
columns are 1,200 B in fp32 but 600 B in bf16).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from krylov_crn_tpu_torch.config import resolve_device

__all__ = ["DualSparse", "build_dual", "dual_from_coo", "from_scipy",
           "padded_dense"]


@dataclasses.dataclass(frozen=True)
class DualSparse:
    """A together with its explicit transpose (and optional dense copies)."""

    a: torch.Tensor  # (n, d) sparse CSR
    at: torch.Tensor  # (d, n) sparse CSR, the transpose of a
    at_indptr: torch.Tensor  # (d + 1,) int64: row offsets of at
    dense: torch.Tensor | None  # (n, d) view with 16-byte-aligned rows
    dense_t: torch.Tensor | None  # (d, n) view, the same for A^T
    max_col_nnz: int

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    @property
    def d(self) -> int:
        return int(self.a.shape[1])

    @property
    def nnz(self) -> int:
        return int(self.a.values().shape[0])

    @property
    def shape(self):
        return (self.n, self.d)

    @property
    def dtype(self) -> torch.dtype:
        return self.a.values().dtype

    @property
    def device(self) -> torch.device:
        return self.a.device


def from_scipy(A, dtype=np.float32, device=None) -> torch.Tensor:
    """A scipy.sparse matrix (any format) as a torch sparse CSR tensor
    (int64 indices, sorted columns within each row) on ``device``."""
    A = A.tocsr()
    if not A.has_sorted_indices:
        A = A.sorted_indices()
    dev = resolve_device(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
        return torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(np.asarray(A.data, dtype)),
            size=A.shape, check_invariants=False).to(dev)


def _csr(row_ids, cols, vals, n_rows, n_cols) -> torch.Tensor:
    """Sparse CSR tensor from entries already sorted by ``row_ids``."""
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(row_ids, minlength=n_rows), 0)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
        # check_invariants=False: the checks read the index arrays back to
        # the host
        return torch.sparse_csr_tensor(crow, cols, vals, size=(n_rows, n_cols),
                                       check_invariants=False)


def dual_from_coo(rows, cols, vals, n: int, d: int) -> DualSparse:
    """DualSparse from row-sorted COO index tensors (int64) on any device,
    built where they lie, with no trip through scipy: A takes the entries
    as they are, A^T the same entries stably sorted by column (so each of
    its rows keeps ascending column order).

    The entries may repeat a (row, column) pair. The products of
    ``ops/spmv`` sum repeats as separate entries, which is the sum of the
    merged matrix; ``ops/coords.gather_columns_dense`` scatters each pair
    once and must not be given such data."""
    order = torch.argsort(cols, stable=True)
    a = _csr(rows, cols, vals, n, d)
    at = _csr(cols[order], rows[order], vals[order], d, n)
    at_indptr = at.crow_indices()
    max_col = int((at_indptr[1:] - at_indptr[:-1]).max()) if d > 0 else 0
    return DualSparse(a=a, at=at, at_indptr=at_indptr, dense=None,
                      dense_t=None, max_col_nnz=max_col)


def padded_dense(t: torch.Tensor, device=None) -> torch.Tensor:
    """``t`` on ``device`` as the (rows, cols) view of a zero-padded
    (rows, ld) buffer, with ld * itemsize a multiple of 16 bytes."""
    dev = resolve_device(device)
    rows, cols = t.shape
    per = 16 // t.element_size()
    ld = -(-cols // per) * per
    buf = torch.zeros((rows, ld), dtype=t.dtype, device=dev)
    buf[:, :cols] = t.to(dev)
    return buf[:, :cols]


def build_dual(
    A,
    dtype=np.float32,
    device=None,
    dense_threshold_bytes: int = 512 * 1024 * 1024,
    want_dense: bool | None = None,
) -> DualSparse:
    """The DualSparse device format of a scipy matrix (or dense array).

    ``want_dense``: force/forbid the dense copies. By default they are
    kept when A fits ``dense_threshold_bytes`` *and* d <= 2048 (the
    regime where the reference picks its "full" cubic solver)."""
    import scipy.sparse as sp

    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    A = A.tocsr()
    if not A.has_canonical_format:
        # duplicates summed: ops/coords.py scatters each (row, column) once
        A = A.copy()
        A.sum_duplicates()
    n, d = A.shape
    At = A.T.tocsr()
    col_counts = np.diff(At.indptr).astype(np.int64)
    max_col = int(col_counts.max()) if d > 0 and col_counts.size else 0
    itemsize = np.dtype(dtype).itemsize
    if want_dense is None:
        want_dense = (n * d * itemsize <= dense_threshold_bytes) and d <= 2048
    dense = dense_t = None
    if want_dense:
        Ad = torch.from_numpy(A.toarray().astype(dtype))
        dense = padded_dense(Ad, device)
        dense_t = padded_dense(Ad.T, device)
    at = from_scipy(At, dtype, device)
    return DualSparse(a=from_scipy(A, dtype, device), at=at,
                      at_indptr=at.crow_indices(), dense=dense,
                      dense_t=dense_t, max_col_nnz=max_col)
