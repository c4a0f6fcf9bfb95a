"""The benchmark's data: seeded stand-ins for LIBSVM's datasets.

Frozen copies of the port's generators (``krylov_crn_tpu_torch/data/
synthetic.py``, PROBLEM_VERSION 4), kept here so that a change to the
program cannot change the problems it is timed on. A configuration names
its generator (``"generator"``), and ``GENERATORS`` holds, for each, what it
builds, the configuration keys it reads and its shape in a CPU test:

* ``topic`` (rcv1-like, news20-like): topic-mixture rows of an exactly
  rank-R row space, nonnegative values, unit-L2 rows, cluster labels, and
  one conflicting twin per topic so that the l2 = 0 optimum is attained;
* ``clustered`` (w8a-like): ``synthetic_logreg``'s "clustered" profile,
  noisy copies of sparse cluster centroids plus Zipf background features,
  nonnegative unit-L2 rows, cluster labels with a few flips, and random
  conflicting twins.

The same (shape, parameters, seed) give the port's generator's bits
(``benchmark/tests/test_benchmark_run.py`` holds them to that).

numpy and scipy only.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.sparse as sp

__all__ = ["PROBLEM_VERSION", "GENERATORS", "Generator", "topic_sparse",
           "topic_logreg", "clustered_sparse", "clustered_logreg", "make",
           "tiny"]

PROBLEM_VERSION = 4


def topic_sparse(n, d, nnz, R=300, n_clusters=20, topics_per_row=3,
                 own_frac=0.6, pop_exp=1.1, seed=0, dtype=np.float32):
    """Rows that are positive mixtures of ``topics_per_row`` of R sparse
    nonnegative topics (rank(A) <= R). Returns (A_csr, row_cluster,
    topic_choice)."""
    rng = np.random.default_rng(seed)
    fpt = max(nnz // (n * topics_per_row), 2)
    tcols = rng.choice(d, size=(R, fpt))
    tvals = np.abs(rng.standard_normal((R, fpt))) + 0.1
    cw = 1.0 / np.arange(1, n_clusters + 1) ** 0.8
    cw /= cw.sum()
    row_cl = rng.choice(n_clusters, size=n, p=cw)
    home = np.arange(R) % n_clusters
    gpop = 1.0 / np.arange(1, R + 1) ** pop_exp
    gpop /= gpop.sum()
    topic_choice = np.empty((n, topics_per_row), np.int64)
    for c in range(n_clusters):
        m = row_cl == c
        nm = int(m.sum())
        own = np.where(home == c)[0]
        opop = 1.0 / np.arange(1, len(own) + 1) ** pop_exp
        opop /= opop.sum()
        topic_choice[m] = np.where(
            rng.random((nm, topics_per_row)) < own_frac,
            own[rng.choice(len(own), (nm, topics_per_row), p=opop)],
            rng.choice(R, (nm, topics_per_row), p=gpop))
    coefs = np.abs(rng.standard_normal((n, topics_per_row))) + 0.2
    rows_i, cols_i, vals_i = [], [], []
    for t in range(topics_per_row):
        tc = topic_choice[:, t]
        rows_i.append(np.repeat(np.arange(n), fpt))
        cols_i.append(tcols[tc].ravel())
        vals_i.append((coefs[:, t:t + 1] * tvals[tc]).ravel())
    A = sp.coo_matrix((np.concatenate(vals_i),
                       (np.concatenate(rows_i), np.concatenate(cols_i))),
                      shape=(n, d)).tocsr()
    A.sum_duplicates()
    return A.astype(dtype), row_cl, topic_choice


def topic_logreg(n, d, nnz, seed, topic_params, conflict_frac=0.02,
                 dtype=np.float32):
    """(A_csr, b): unit-L2 nonnegative topic rows and labels in {-1, +1},
    with conflicting twins that cover every topic."""
    A, row_cl, topic_choice = topic_sparse(n, d, nnz, seed=seed, dtype=dtype,
                                           **topic_params)
    A.data = np.abs(A.data)
    rn = np.sqrt(np.asarray(A.multiply(A).sum(axis=1)).ravel())
    inv = np.where(rn > 0, 1.0 / np.maximum(rn, 1e-30), 0.0)
    A = sp.diags(inv).dot(A).tocsr().astype(dtype)
    rng = np.random.default_rng(seed + 1)
    cl_label = np.where(rng.random(int(row_cl.max()) + 1) < 0.5, -1.0, 1.0)
    b = cl_label[row_cl]
    k = int(conflict_frac * n / 2)
    if k > 0:
        perm = rng.permutation(n)
        flat_topics = topic_choice[perm].ravel()
        flat_rows = np.repeat(perm, topic_choice.shape[1])
        _, first = np.unique(flat_topics, return_index=True)
        cover = np.unique(flat_rows[first])
        k = max(k, len(cover))
        if 2 * k > n:
            raise ValueError(f"conflict twins need 2k={2 * k} distinct rows "
                             f"to cover {len(cover)} topics but n={n}")
        pool = np.setdiff1d(np.arange(n), cover)
        extra = rng.choice(pool, size=2 * k - len(cover), replace=False)
        src = np.concatenate([cover, extra[: k - len(cover)]])
        dst = extra[k - len(cover):]
        coo = A.tocoo()
        keep = ~np.isin(coo.row, dst)
        starts = A.indptr[src]
        ends = A.indptr[src + 1]
        new_rows = np.repeat(dst, ends - starts)
        take = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
        rows = np.concatenate([coo.row[keep], new_rows])
        cols = np.concatenate([coo.col[keep], A.indices[take]])
        vals = np.concatenate([coo.data[keep], A.data[take]])
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, d)).tocsr()
        b[dst] = -b[src]
    return A, b


def clustered_sparse(n, d, nnz, n_clusters=50, mix=0.7,
                     feats_per_cluster=300, seed=0, dtype=np.float32):
    """Rows that are noisy copies of one of ``n_clusters`` sparse centroids
    (``mix`` of a row's entries) plus Zipf background features. Returns
    (A_csr, row_cluster)."""
    rng = np.random.default_rng(seed)
    cw = 1.0 / np.arange(1, n_clusters + 1) ** 0.8
    cw /= cw.sum()
    row_cl = rng.choice(n_clusters, size=n, p=cw)
    feat = rng.choice(d, size=(n_clusters, feats_per_cluster), replace=True)
    fval = np.abs(rng.standard_normal((n_clusters, feats_per_cluster)))
    k = max(nnz // n, 2)
    kc = max(int(mix * k), 1)
    kn = max(k - kc, 1)
    pick = rng.integers(0, feats_per_cluster, size=(n, kc))
    rows_s = np.repeat(np.arange(n), kc)
    cols_s = feat[row_cl[:, None], pick].ravel()
    vals_s = (fval[row_cl[:, None], pick].ravel()
              * (1 + 0.3 * rng.standard_normal(n * kc)))
    w = 1.0 / np.arange(1, d + 1) ** 1.1
    w /= w.sum()
    cols_n = rng.choice(d, size=n * kn, p=w)
    rows_n = np.repeat(np.arange(n), kn)
    vals_n = np.abs(rng.standard_normal(n * kn))
    A = sp.coo_matrix(
        (np.concatenate([vals_s, vals_n]),
         (np.concatenate([rows_s, rows_n]),
          np.concatenate([cols_s, cols_n]))), shape=(n, d)).tocsr()
    A.sum_duplicates()
    return A.astype(dtype), row_cl


def clustered_logreg(n, d, nnz, seed, cluster_params, conflict_frac=0.02,
                     flip_frac=0.005, dtype=np.float32):
    """(A_csr, b): unit-L2 nonnegative clustered rows and labels in
    {-1, +1}: one label a cluster, a ``flip_frac`` share flipped, and
    ``conflict_frac`` n / 2 random rows copied onto others with the opposite
    label."""
    A, row_cl = clustered_sparse(n, d, nnz, seed=seed, dtype=dtype,
                                 **cluster_params)
    A.data = np.abs(A.data)
    rn = np.sqrt(np.asarray(A.multiply(A).sum(axis=1)).ravel())
    inv = np.where(rn > 0, 1.0 / np.maximum(rn, 1e-30), 0.0)
    A = sp.diags(inv).dot(A).tocsr().astype(dtype)
    rng = np.random.default_rng(seed + 1)
    cl_label = np.where(rng.random(int(row_cl.max()) + 1) < 0.5, -1.0, 1.0)
    b = cl_label[row_cl]
    if flip_frac > 0:
        b[rng.random(n) < flip_frac] *= -1
    k = int(conflict_frac * n / 2)
    if k > 0:
        idx = rng.choice(n, size=2 * k, replace=False)
        src, dst = idx[:k], idx[k:]
        coo = A.tocoo()
        keep = ~np.isin(coo.row, dst)
        starts = A.indptr[src]
        ends = A.indptr[src + 1]
        new_rows = np.repeat(dst, ends - starts)
        take = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])
        rows = np.concatenate([coo.row[keep], new_rows])
        cols = np.concatenate([coo.col[keep], A.indices[take]])
        vals = np.concatenate([coo.data[keep], A.data[take]])
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, d)).tocsr()
        b[dst] = -b[src]
    return A, b


class Generator(NamedTuple):
    """A generator that configurations name: ``build(config)`` gives
    (A_csr, b); ``keys`` are the configuration keys it reads; ``tiny(config)``
    the keys that bring the configuration to a CPU test's size."""

    build: Callable[[dict], tuple]
    keys: tuple
    tiny: Callable[[dict], dict]


GENERATORS = {
    "topic": Generator(
        build=lambda c: topic_logreg(
            c["n_rows"], c["n_features"], c["nnz_drawn"], int(c["data_seed"]),
            c["topic_params"], conflict_frac=c["conflict_frac"],
            dtype=np.dtype(c["dtype"])),
        keys=("n_rows", "n_features", "nnz_drawn", "data_seed",
              "topic_params", "conflict_frac", "dtype"),
        # 1,200 x 5,000 rows of 30 topics: the conflict twins still cover
        # every topic (2k <= n)
        tiny=lambda c: dict(n_rows=1200, n_features=5000, nnz_drawn=60000,
                            topic_params=dict(c["topic_params"], R=30,
                                              n_clusters=5))),
    "clustered": Generator(
        build=lambda c: clustered_logreg(
            c["n_rows"], c["n_features"], c["nnz_drawn"], int(c["data_seed"]),
            c["cluster_params"], conflict_frac=c["conflict_frac"],
            flip_frac=c["flip_frac"], dtype=np.dtype(c["dtype"])),
        keys=("n_rows", "n_features", "nnz_drawn", "data_seed",
              "cluster_params", "conflict_frac", "flip_frac", "dtype"),
        # 1,200 rows of the configuration's own width and entries a row:
        # at d <= 2048 the program builds the dense copies, as on the card
        tiny=lambda c: dict(n_rows=1200, nnz_drawn=round(
            1200 * c["nnz_drawn"] / c["n_rows"]))),
}


def _generator(config: dict) -> Generator:
    gen = GENERATORS.get(config["generator"])
    if gen is None or config["problem_version"] != PROBLEM_VERSION:
        raise ValueError(f"{config['name']}: generator "
                         f"{config['generator']} v{config['problem_version']}"
                         f" is not one of this file's {sorted(GENERATORS)} "
                         f"v{PROBLEM_VERSION}")
    missing = [k for k in gen.keys if k not in config]
    if missing:
        raise ValueError(f"{config['name']}: {config['generator']} reads "
                         f"{missing}, which the configuration lacks")
    return gen


def make(config: dict):
    """(A_csr fp32, b in {-1, +1}) of a configuration file's problem (its
    ``data_seed``), by the generator it names."""
    return _generator(config).build(config)


def tiny(config: dict) -> dict:
    """The configuration at its generator's size for a CPU test."""
    return dict(config, **_generator(config).tiny(config))
