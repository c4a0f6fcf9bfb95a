"""Coordinate-subspace (column) operations for SSCN.

Port of ``krylov_crn_tpu/ops/coords.py``. The reference slices CSC columns
``A[:, I]`` on the host (optimizer/loss.py:234-264); here the sampled
columns become a **dense n x m panel B** in one shot:

1. window-gather each sampled column's nnz from the stored transpose
   (offsets from ``at_indptr``, padded to ``max_col_nnz`` and masked);
2. scatter the m x K window into B.

Everything downstream is dense: partial gradient Bᵀ r / n, partial
Hessian Bᵀ diag(w) B / n, and the margin update Ax += B @ s.
"""

from __future__ import annotations

import torch

from krylov_crn_tpu_torch.data.formats import DualSparse

__all__ = ["gather_columns_dense"]


def gather_columns_dense(data: DualSparse, I: torch.Tensor,
                         k_pad: int | None = None) -> torch.Tensor:
    """B = dense A[:, I], shape (n, m), for an index vector I (m,) of
    distinct columns, on the data's device."""
    if k_pad is None:
        k_pad = data.max_col_nnz
    n = data.n
    m = int(I.shape[0])
    I = I.to(device=data.device, dtype=torch.int64)
    indptr = data.at_indptr
    at_vals, at_cols = data.at.values(), data.at.col_indices()
    offs = indptr[I]  # (m,)
    counts = indptr[I + 1] - offs
    k = torch.arange(k_pad, dtype=torch.int64, device=data.device)
    mask = k[None, :] < counts[:, None]  # (m, K)
    idx = torch.where(mask, offs[:, None] + k[None, :], 0)
    vals = torch.where(mask, at_vals[idx], 0.0)
    rows = torch.where(mask, at_cols[idx], n)  # row ids of A; n = dump row
    col_of = torch.arange(m, dtype=torch.int64,
                          device=data.device)[:, None].expand(m, k_pad)
    B = torch.zeros((n + 1, m), dtype=at_vals.dtype, device=data.device)
    # A plain scatter, no accumulation: a canonical CSR holds each (row,
    # column) pair once, so every real entry of B is written exactly once;
    # only the masked padding collides, on the dump row n, and every such
    # write is 0.0. The result is therefore the same bits on every run,
    # where index_put_(accumulate=True) would add with atomics on a card.
    B.index_put_((rows.reshape(-1), col_of.reshape(-1)), vals.reshape(-1))
    return B[:n]
