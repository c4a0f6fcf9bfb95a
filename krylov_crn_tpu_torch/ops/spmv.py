"""Sparse matrix products: SpMV, transpose SpMV, fused logistic HVP.

Port of ``krylov_crn_tpu/ops/spmv.py``. Three branches, picked by the
data:

* **sharded** (``parallel.sharded.ShardedDual``): the local product on this
  rank's row block; ``A^T z`` then takes one all-reduce of the d-vector,
  ``A x`` none. A fused HVP therefore costs exactly one collective;
* **dense** (``DualSparse.dense`` present, small d): ``A x`` on the dense
  copy of A and ``A^T z`` on the dense copy of A^T, both through the
  hand-written matvec kernel (``ops/matvec.py``) on a card;
* **sparse**: a CSR product, one fixed-order reduction per row segment
  (gather, multiply, ``torch.segment_reduce`` over the CSR row offsets).
  A^T z runs the same product on the stored transpose. No atomics:
  ``index_add_`` and COO sums on a card add in a different order on each
  run, and cuSPARSE's default CSR algorithm does not promise the same
  bits either, while the solvers compare values across iterations.

``dense_matvec.cuda_calls`` counts the dense-branch products made on a
card, so a run can show that each one launched the kernel
(``matvec.launches``).
"""

from __future__ import annotations

import torch

from krylov_crn_tpu_torch.data.formats import DualSparse
from krylov_crn_tpu_torch.ops.matvec import matvec

__all__ = ["spmv_csr", "dense_matvec", "spmv", "rmatvec", "hvp_sparse",
           "row_sqnorms"]


def spmv_csr(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M @ x for a sparse CSR ``M``: each row's products summed in
    one deterministic segment reduction."""
    prod = M.values() * x.index_select(0, M.col_indices())
    return torch.segment_reduce(prod, "sum", offsets=M.crow_indices())


def dense_matvec(K, x):
    """K @ x on a dense copy: the matvec kernel on a card, its plain
    version on the CPU; ``dense_matvec.cuda_calls`` counts the calls on a
    card."""
    if K.is_cuda:
        dense_matvec.cuda_calls += 1
    return matvec(K, x)


dense_matvec.cuda_calls = 0


def _sharded():
    # imported at call time: parallel.sharded builds on this module
    from krylov_crn_tpu_torch.parallel import sharded

    return sharded


def spmv(data, x: torch.Tensor) -> torch.Tensor:
    """Ax: the row-sharded local product, the dense matvec when the dense
    copy exists, else CSR."""
    if not isinstance(data, DualSparse):
        return _sharded().sharded_spmv(data, x)
    if data.dense is not None:
        return dense_matvec(data.dense, x)
    return spmv_csr(data.a, x)


def rmatvec(data, z: torch.Tensor) -> torch.Tensor:
    """A^T z (d-vector) through the stored transpose: no scatter. Sharded
    data all-reduces the d-vector over the ranks."""
    if not isinstance(data, DualSparse):
        return _sharded().sharded_rmatvec(data, z)
    if data.dense_t is not None:
        return dense_matvec(data.dense_t, z)
    return spmv_csr(data.at, z)


def hvp_sparse(data, w: torch.Tensor, v: torch.Tensor,
               l2: float = 0.0, n_scale: float | None = None) -> torch.Tensor:
    """Generalized-linear-model HVP  A^T (w * (A v)) / n + l2 * v, never
    materializing the Hessian (reference loss.py:289-302)."""
    n = data.n if n_scale is None else n_scale
    out = rmatvec(data, w * spmv(data, v)) / n
    if l2:
        out = out + l2 * v
    return out


def row_sqnorms(M: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms of a sparse CSR matrix (replaces sklearn
    row_norms, reference loss.py:327,335,344)."""
    vals = M.values()
    return torch.segment_reduce(vals * vals, "sum", offsets=M.crow_indices())
