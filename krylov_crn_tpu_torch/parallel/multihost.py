"""Multi-process execution: joining the group, per-rank data loading.

Counterpart of ``krylov_crn_tpu/parallel/multihost.py``:

* ``init_distributed`` — joins the ``torch.distributed`` process group of
  a launcher (``torchrun`` publishes rank, world size and the master's
  address in the environment) or of explicit arguments; a no-op for a
  single process;
* ``split_bytes_by_rows`` / ``load_libsvm_rows`` — each rank reads and
  parses ONLY its byte range of the LIBSVM text file (the byte count is a
  faithful nnz proxy, so contiguous byte-balanced splits are nnz-balanced
  without a pass over the whole file);
* ``global_label_coding`` — one value -> bit coding of the labels agreed
  across the ranks;
* ``load_sharded_libsvm`` — the per-rank pipeline: parse the local rows,
  agree on the global (d, sizes) across the ranks, build this rank's
  ``ShardedDual`` block and its padded labels.

A mesh of one rank follows the identical code path; the cross-rank
agreements reduce to identities (``mesh.all_gather_host``).
"""

from __future__ import annotations

import os

import numpy as np

from krylov_crn_tpu_torch.parallel.mesh import Mesh, all_gather_host

__all__ = ["init_distributed", "global_label_coding", "split_bytes_by_rows",
           "load_libsvm_rows", "load_sharded_libsvm"]


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     backend: str | None = None) -> int:
    """Join the process group; returns this process's rank.

    With no arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
    them) and is a no-op, returning 0, in a single process without them.
    ``backend`` defaults to NCCL when every rank of this host has a card
    of its own, else gloo."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world_size in (None, 1) and env_world == 1:
        return 0  # single-process run: nothing to initialize
    if world_size is None:
        world_size = env_world
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return dist.get_rank()


def global_label_coding(labels: np.ndarray, allgather=None) -> np.ndarray:
    """Labels -> {0,1} with a value->bit coding agreed ACROSS ranks.

    ``canonicalize_labels``' "any other pair -> first-seen label" rule
    (data/libsvm.py; reference loss.py:190-207 semantics) depends on the
    order: two ranks whose byte ranges start with different classes would
    code the labels oppositely, a silent class inversion. This gathers the
    distinct label values and the globally first label (rank 0's first
    row) and applies one shared coding: {0,1}/{1,2}/{-1,1} by the standard
    maps, any other pair -> 1 for the global first-seen label.
    ``allgather`` maps this rank's 4-vector to the (ranks, 4) stack of all
    of them (``mesh.all_gather_host`` bound to a mesh; injectable for
    tests; the identity of one rank by default)."""
    if allgather is None:
        allgather = lambda x: x[None]
    labels = np.asarray(labels)
    lu = np.unique(labels) if labels.size else np.empty(0)
    pad = np.full(3, np.nan)
    pad[: min(len(lu), 3)] = lu[:3]
    first = float(labels[0]) if labels.size else np.nan
    gath = np.atleast_2d(allgather(np.array([*pad, first], np.float64)))
    vals_seen = gath[:, :3].ravel()
    gl = np.unique(vals_seen[~np.isnan(vals_seen)])
    if len(gl) > 2:
        raise ValueError(
            "The number of classes must be no more than 2 for binary "
            f"classification (saw values {gl[:4]}...)")
    firsts = gath[:, 3]
    firsts = firsts[~np.isnan(firsts)]
    first_global = float(firsts[0]) if firsts.size else 0.0
    if np.array_equal(gl, [0, 1]):
        return labels.astype(np.float64)
    if np.array_equal(gl, [1, 2]):
        return (labels - 1).astype(np.float64)
    if np.array_equal(gl, [-1, 1]):
        return ((labels + 1) / 2).astype(np.float64)
    return (labels == first_global).astype(np.float64)


def split_bytes_by_rows(path: str, num_parts: int,
                        part: int) -> tuple[int, int]:
    """Contiguous byte range [start, end) of ``part``, snapped to line
    boundaries. Byte-balanced splits of LIBSVM text are nnz-balanced to
    first order (bytes per line scale with tokens per line)."""
    size = os.path.getsize(path)
    targets = [size * i // num_parts for i in range(num_parts + 1)]

    def snap(off):
        if off in (0, size):
            return off
        with open(path, "rb") as fh:
            fh.seek(off)
            # advance to the next newline so rows are never split
            chunk = fh.read(1 << 20)
            j = chunk.find(b"\n")
            return off + j + 1 if j >= 0 else size

    start = snap(targets[part])
    end = snap(targets[part + 1])
    return start, min(max(end, start), size)


def load_libsvm_rows(path: str, byte_range: tuple[int, int],
                     backend: str = "auto"):
    """Parse only [start, end) of the file -> (labels, rows, cols, vals)
    with *local* row ids and raw (possibly 1-based) column ids."""
    from krylov_crn_tpu_torch.data.libsvm import _parse_native, _parse_python

    start, end = byte_range
    with open(path, "rb") as fh:
        fh.seek(start)
        data = fh.read(end - start)
    if backend == "auto":
        try:
            return _parse_native(data)
        except Exception:
            return _parse_python(data)
    if backend == "native":
        return _parse_native(data)
    return _parse_python(data)


def load_sharded_libsvm(path: str, mesh: Mesh, dtype=np.float32,
                        zero_based: str | bool = "auto",
                        backend: str = "auto"):
    """Per-rank LIBSVM -> this rank's ``ShardedDual`` + padded labels.

    Every rank parses its own byte range (never the whole file) and keeps
    its rows as its block; the ranks agree on the column count, the index
    base, the label coding and the uniform padded block height. Returns
    ``(ShardedDual, b_padded)`` with ``b_padded`` this rank's {0,1} labels
    in the padded (n_local,) layout, a tensor on the mesh's device."""
    import scipy.sparse as sp
    import torch

    from krylov_crn_tpu_torch.parallel.sharded import (
        _padded_block,
        _round_up,
        sharded_from_block,
    )

    byte_range = split_bytes_by_rows(path, mesh.world, mesh.rank)
    labels, rows, cols, vals = load_libsvm_rows(path, byte_range,
                                                backend=backend)

    # ---- global agreement: column count, 0/1-basing, sizes ----
    local_meta = np.array([
        int(cols.max()) + 1 if cols.size else 0,  # d upper bound (raw ids)
        int(cols.min()) if cols.size else 1,      # min col id seen
        labels.shape[0],                          # local row count
        rows.shape[0],                            # local nnz
    ], np.int64)
    metas = all_gather_host(mesh, local_meta)
    d = int(metas[:, 0].max())
    if zero_based == "auto":
        zero_based = int(metas[:, 1].min()) == 0
    if not zero_based:
        cols = cols - 1
        d -= 1
    row_counts = [int(c) for c in metas[:, 2]]

    b01 = global_label_coding(labels, lambda x: all_gather_host(mesh, x))

    n_loc = labels.shape[0]
    A_loc = sp.csr_matrix((vals, (rows, cols)), shape=(n_loc, d),
                          dtype=np.float64)
    n_l = _round_up(max(max(row_counts), 1), 8)
    sd = sharded_from_block(
        _padded_block(A_loc, 0, n_loc, n_l), n_loc, sum(row_counts),
        int(metas[:, 3].sum()), row_counts, mesh, dtype)
    b_pad = torch.zeros(n_l, dtype=sd.dtype, device=sd.device)
    b_pad[:n_loc] = torch.from_numpy(b01).to(b_pad)
    return sd, b_pad
