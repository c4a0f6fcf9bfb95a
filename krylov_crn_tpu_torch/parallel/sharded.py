"""Row-partitioned sparse data and its products over a ``Mesh``.

Counterpart of ``krylov_crn_tpu/parallel/sharded.py``: the multi-device
analogue of ``DualSparse``. Layout over the 1-D mesh:

* rows of A are split into contiguous, **nnz-balanced** blocks
  (``partition_rows``, the JAX package's rule bit for bit: power-law row
  lengths make row-count balancing badly skewed); every block is padded
  with empty rows to the uniform height ``n_local``, so row-sharded
  vectors have one shape on every rank and gather with one collective;
* each rank holds only its block and the block's transpose, in the port's
  own device format (``DualSparse``: CSR with the fixed-order segment
  reduction of ``ops/spmv``). The JAX package pads every shard's nnz to a
  common length so that the shards stack into one array; separate
  processes need no such padding;
* the dense iterate x is replicated; margins, labels and ``mask`` (1 on
  real rows, 0 on padding) are row-sharded.

Communication per fused HVP:

    A v        : local product, no collective      (v replicated)
    w * Av     : local elementwise on the block
    A^T (...)  : local transpose product -> ONE all-reduce of the d-vector

``shard_layout`` lays out all D blocks in one process (numpy and scipy
only), which is how a test holds the layout against the JAX arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from krylov_crn_tpu_torch.data.formats import DualSparse, build_dual
from krylov_crn_tpu_torch.ops.coords import gather_columns_dense
from krylov_crn_tpu_torch.ops.spmv import row_sqnorms, spmv_csr
from krylov_crn_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
)

__all__ = ["ShardedDual", "partition_rows", "shard_layout",
           "build_sharded_dual", "sharded_from_block", "pad_rowvec",
           "gather_rowvec", "sharded_spmv", "sharded_rmatvec",
           "sharded_row_sqnorms", "sharded_gather_columns"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedDual:
    """This rank's row block of A (and its transpose) over a mesh."""

    local: DualSparse  # (n_local, d) block, padding rows empty
    mask: torch.Tensor  # (n_local,) 1 on real rows, 0 on padding
    n: int  # true rows of the whole A
    d: int
    nnz: int  # entries of the whole A
    n_local: int  # uniform padded block height
    row_counts: tuple  # real rows of every rank's block, in rank order
    mesh: Mesh

    # DualSparse's interface, as shared code reads it
    @property
    def dense(self):
        return None

    @property
    def shape(self):
        return (self.n, self.d)

    @property
    def n_shards(self) -> int:
        return self.mesh.world

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.n_local

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device


def partition_rows(indptr: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous nnz-balanced row ranges from a CSR indptr."""
    nnz = int(indptr[-1])
    targets = [round(nnz * (i + 1) / n_shards) for i in range(n_shards)]
    bounds = np.searchsorted(indptr, targets, side="left")
    bounds = np.clip(bounds, 0, len(indptr) - 1)
    ranges = []
    start = 0
    for i, b in enumerate(bounds):
        end = int(b) if i < n_shards - 1 else len(indptr) - 1
        end = max(end, start)  # allow empty shards in degenerate cases
        ranges.append((start, end))
        start = end
    return ranges


def _padded_block(A, start: int, end: int, n_local: int):
    """Rows [start, end) of the CSR ``A`` as an (n_local, d) CSR whose
    rows past end - start are empty."""
    import scipy.sparse as sp

    blk = A[start:end]
    indptr = np.concatenate([
        blk.indptr, np.full(n_local - (end - start), blk.indptr[-1],
                            blk.indptr.dtype)])
    return sp.csr_matrix((blk.data, blk.indices, indptr),
                         shape=(n_local, A.shape[1]))


def shard_layout(A, n_shards: int) -> dict:
    """All ``n_shards`` blocks of the layout, on the host: ``ranges`` (the
    row range of every block), ``n_local`` (the largest block rounded up to
    a multiple of 8, the JAX package's rule), ``blocks`` (scipy CSR,
    (n_local, d) each) and ``masks`` (float64 (n_local,) each)."""
    A = A.tocsr()
    ranges = partition_rows(A.indptr, n_shards)
    n_l = _round_up(max(max(e - s for s, e in ranges), 1), 8)
    masks = []
    for s, e in ranges:
        m = np.zeros(n_l)
        m[:e - s] = 1
        masks.append(m)
    return dict(ranges=ranges, n_local=n_l, masks=masks,
                blocks=[_padded_block(A, s, e, n_l) for s, e in ranges])


def sharded_from_block(block, n_rows: int, n: int, nnz: int, row_counts,
                       mesh: Mesh, dtype=np.float32) -> ShardedDual:
    """The ``ShardedDual`` of this rank from its padded (n_local, d) scipy
    block, of which the first ``n_rows`` rows are real."""
    local = build_dual(block, dtype=dtype, device=mesh.device,
                       want_dense=False)
    n_l = int(block.shape[0])
    mask = torch.zeros(n_l, dtype=local.dtype, device=mesh.device)
    mask[:n_rows] = 1
    return ShardedDual(local=local, mask=mask, n=int(n), d=int(block.shape[1]),
                       nnz=int(nnz), n_local=n_l,
                       row_counts=tuple(int(c) for c in row_counts),
                       mesh=mesh)


def build_sharded_dual(A, mesh: Mesh, dtype=np.float32) -> ShardedDual:
    """Partition a scipy matrix over the mesh; every rank calls this with
    the same ``A`` and keeps its own block."""
    A = A.tocsr()
    if not A.has_canonical_format:
        A = A.copy()
        A.sum_duplicates()
    ranges = partition_rows(A.indptr, mesh.world)
    n_l = _round_up(max(max(e - s for s, e in ranges), 1), 8)
    s, e = ranges[mesh.rank]
    return sharded_from_block(_padded_block(A, s, e, n_l), e - s, A.shape[0],
                              A.nnz, [e - s for s, e in ranges], mesh, dtype)


def pad_rowvec(v: np.ndarray, sd: ShardedDual, dtype=None) -> torch.Tensor:
    """This rank's (n_local,) slice of an n-vector (labels, weights) in the
    padded row-sharded layout, zero on padding rows."""
    v = np.asarray(v)
    if v.shape[0] != sd.n:
        raise ValueError(f"pad_rowvec: the vector has {v.shape[0]} rows, "
                         f"A has {sd.n}")
    start = sum(sd.row_counts[:sd.mesh.rank])
    cnt = sd.row_counts[sd.mesh.rank]
    out = torch.zeros(sd.n_local, dtype=sd.dtype if dtype is None else dtype,
                      device=sd.device)
    out[:cnt] = torch.from_numpy(np.ascontiguousarray(v[start:start + cnt])
                                 ).to(out)
    return out


def gather_rowvec(sd: ShardedDual, y: torch.Tensor) -> torch.Tensor:
    """The whole n-vector (padding stripped) of a row-sharded (n_local,)
    vector, on every rank: one all-gather."""
    full = all_gather_rows(sd.mesh, y).reshape(sd.n_shards, sd.n_local)
    return torch.cat([full[i, :c] for i, c in enumerate(sd.row_counts)])


def sharded_spmv(sd: ShardedDual, x: torch.Tensor) -> torch.Tensor:
    """Ax: replicated x -> row-sharded margins (n_local,). No collective."""
    return spmv_csr(sd.local.a, x)


def sharded_rmatvec(sd: ShardedDual, z: torch.Tensor) -> torch.Tensor:
    """A^T z: row-sharded z -> replicated d-vector through one
    all-reduce."""
    return all_reduce_sum(sd.mesh, spmv_csr(sd.local.at, z))


def sharded_row_sqnorms(sd: ShardedDual) -> torch.Tensor:
    """Per-row squared norms, row-sharded (padding rows report 0)."""
    return row_sqnorms(sd.local.a)


def sharded_gather_columns(sd: ShardedDual, I: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the dense column panel B = A[:, I], shape
    (n_local, m). Each rank owns its rows' slice of every column in its
    block's stored transpose, so the panel assembles with no collective;
    SSCN's partials reduce it afterwards (H_I = sum over ranks of the
    local B^T W B)."""
    return gather_columns_dense(sd.local, I)
