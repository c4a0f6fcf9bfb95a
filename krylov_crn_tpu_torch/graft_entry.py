"""Entry points for a harness: a single-device step and a multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py``.

* ``entry(device=None)`` — ``(fn, args)``: one d-space Krylov-CRN step
  (the flagship solver) on a small synthetic logistic problem; ``fn(*args)``
  returns the next state. On ``cuda:0`` unless ``device="cpu"``.
* ``dryrun_multidevice(n_ranks, device)`` — starts ``n_ranks`` ranks
  (``parallel.launch``) and runs, on tiny shapes, the four legs of the
  multi-device layer, each with its "must not increase the loss"
  assertion: a row-sharded d-space step, a Gram step on a row-banded K,
  the whole fused race under the mesh (``it_max=8, chunk=4,
  certify=True``), and a per-rank LIBSVM byte-range load followed by one
  step. ``device``: ``"cpu"`` (gloo), one shared card such as ``"cuda:0"``
  (gloo: NCCL refuses two ranks on one device) or ``"cuda"`` (a card per
  rank, NCCL).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

__all__ = ["entry", "dryrun_multidevice"]


def _tiny_problem(n=512, d=1024, nnz=8192, seed=0, dtype=np.float32):
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    return synthetic_logreg((n, d, nnz), seed=seed, dtype=dtype)


def _init_state(loss, x0):
    from krylov_crn_tpu_torch.solvers.krylov_crn import (
        KrylovState,
        initial_state,
    )

    return initial_state(loss, x0, 1e-3, KrylovState)


def _value(state) -> float:
    return float(state.value) + float(state.value_lo)


def _leg(what: str, before: float, after: float, slack: float = 0.0):
    """(before, after) of one leg; raises if the loss went up."""
    if not after <= before + slack:
        raise RuntimeError(f"{what} must not increase the loss: "
                           f"{before!r} -> {after!r}")
    return before, after


def entry(device=None):
    """(fn, example_args): a Krylov-CRN training step on a small synthetic
    logistic problem."""
    import torch

    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.solvers.krylov_crn import krylov_step

    A, b = _tiny_problem()
    loss = LogisticRegression(A, b, l2=1e-3, dtype=np.float32, device=device,
                              want_dense=False)
    state = _init_state(loss, np.full(A.shape[1], 0.5, np.float32))

    def fn(data, labels, state):
        return krylov_step(data, labels, state, m=10, l2=1e-3,
                           accum_dtype=torch.float32)

    return fn, (loss.data, loss.b_t, state)


def _write_libsvm(path, A, b):
    Ac = A.tocsr()
    with open(path, "w") as fh:
        for i in range(Ac.shape[0]):
            row = Ac.getrow(i).tocoo()
            toks = " ".join(f"{j + 1}:{v:.9g}"
                            for j, v in zip(row.col, row.data))
            fh.write(f"{int(b[i])} {toks}\n")


def _dryrun_rank(mesh, libsvm_path):
    """One rank of the dry run; returns the legs' (before, after) values."""
    import torch

    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.parallel.multihost import load_sharded_libsvm
    from krylov_crn_tpu_torch.parallel.sharded import build_sharded_dual
    from krylov_crn_tpu_torch.solvers.krylov_crn import krylov_step
    from krylov_crn_tpu_torch.solvers.krylov_gram import (
        GramKrylov,
        gram_krylov_step,
    )

    D = mesh.world
    A, b = _tiny_problem(n=64 * D, d=256, nnz=2048 * D)
    x0 = np.full(A.shape[1], 0.5, np.float32)
    out = {}

    # row-sharded d-space step
    sd = build_sharded_dual(A, mesh, dtype=np.float32)
    loss = LogisticRegression(sd, b, l2=1e-3)
    state = _init_state(loss, x0)
    new = krylov_step(loss.data, loss.b_t, state, m=6, l2=1e-3,
                      accum_dtype=torch.float32)
    out["dspace"] = _leg("training step", _value(state), _value(new))

    # Gram step on the row-banded K: each K-matvec is a local
    # (n_pad/D x n_pad) product and one all-gather
    loss_g = LogisticRegression(A, b, l2=1e-3, dtype=np.float32,
                                device=mesh.device)
    alg = GramKrylov(loss=loss_g, reg_coef=1e-3, subspace_dim=6, tolerance=0,
                     label="gram", mesh=mesh)
    gstate = alg.init_state(x0, 42)
    gnew = gram_krylov_step(alg.gd, gstate, m=6, l2=1e-3,
                            accum_dtype=torch.float32)
    out["gram"] = _leg("gram training step", _value(gstate), _value(gnew))

    # the whole fused race under the mesh: chunks, exact fp64 reinjection,
    # certification and trust-but-verify on every rank
    loss_f = LogisticRegression(A, b, dtype=np.float32, device=mesh.device)
    alg_f = GramKrylov(loss=loss_f, reg_coef=1e-3, subspace_dim=6,
                       tolerance=0, label="gram-fused", mesh=mesh)
    tr = alg_f.run_fused(x0, it_max=8, chunk=4, certify=True)
    fs = list(tr.metrics["exact_fs"])
    if not fs:
        raise RuntimeError("certified fused run produced no exact values")
    out["fused"] = _leg("fused sharded race", float(tr.loss_vals[0]),
                        float(fs[-1]), 1e-12)

    # per-rank byte-range LIBSVM read -> this rank's block -> one step
    sd2, b_pad = load_sharded_libsvm(libsvm_path, mesh, dtype=np.float32)
    loss_mh = LogisticRegression(sd2, b_pad, l2=1e-3)
    st = _init_state(loss_mh, np.full(sd2.d, 0.5, np.float32))
    st2 = krylov_step(loss_mh.data, loss_mh.b_t, st, m=6, l2=1e-3,
                      accum_dtype=torch.float32)
    out["libsvm"] = _leg("the step on per-rank-loaded data", _value(st),
                         _value(st2))
    out["collectives"] = mesh.counts_snapshot()
    return out


def dryrun_multidevice(n_ranks: int, device: str = "cuda:0",
                       timeout: float = 300.0) -> list:
    """Run the four legs in ``n_ranks`` ranks; returns every rank's values
    and raises if a rank fails or the ranks disagree."""
    from krylov_crn_tpu_torch.parallel.launch import backend_for, run_ranks

    with tempfile.TemporaryDirectory(prefix="kcrn_dryrun_") as tmp:
        A, b = _tiny_problem(n=64 * n_ranks, d=256, nnz=2048 * n_ranks)
        path = os.path.join(tmp, "tiny.libsvm")
        _write_libsvm(path, A, np.asarray(b))
        results = run_ranks(_dryrun_rank, n_ranks, backend_for(device),
                            device, timeout, path)
    for leg in ("dspace", "gram", "fused", "libsvm"):
        if any(r[leg] != results[0][leg] for r in results[1:]):
            raise RuntimeError(f"dryrun_multidevice: the ranks disagree on "
                               f"leg {leg}: {[r[leg] for r in results]}")
    return results
