"""The benchmark's data: seeded stand-ins for LIBSVM's rcv1 and news20.

A frozen copy of the topic-row generator of the port
(``krylov_crn_tpu_torch/data/synthetic.py``, PROBLEM_VERSION 4), kept here
so that a change to the program cannot change the problems it is timed on.
Only the path the configurations use is copied: topic-mixture rows of an
exactly rank-R row space, nonnegative values, unit-L2 rows, cluster labels,
and one conflicting twin per topic so that the l2 = 0 optimum is attained.
The same (shape, parameters, seed) give the port's generator's bits
(``benchmark/tests/test_benchmark_run.py`` holds it to that).

numpy and scipy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["PROBLEM_VERSION", "topic_sparse", "topic_logreg", "make"]

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


def make(config: dict):
    """(A_csr fp32, b in {-1, +1}) of a configuration file's problem (its
    ``data_seed``)."""
    if config["generator"] != "topic" or (
            config["problem_version"] != PROBLEM_VERSION):
        raise ValueError(f"{config['name']}: generator "
                         f"{config['generator']} v{config['problem_version']}"
                         f" is not this file's topic v{PROBLEM_VERSION}")
    return topic_logreg(config["n_rows"], config["n_features"],
                        config["nnz_drawn"], int(config["data_seed"]),
                        config["topic_params"],
                        conflict_frac=config["conflict_frac"],
                        dtype=np.dtype(config["dtype"]))
