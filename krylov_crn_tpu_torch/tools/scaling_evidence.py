"""Collective counts and bytes per solver step over a mesh.

    python -m krylov_crn_tpu_torch.tools.scaling_evidence \\
        [--shapes toy rcv1-like] [--ranks 4] [--device cuda:0|cuda|cpu] \\
        [--out artifacts/scaling_torch/collectives.json]

Port of ``tools/scaling_evidence.py``. The JAX tool reads the collectives
out of compiled HLO; the port calls every collective itself, so the tool
runs each program once in ``--ranks`` ranks and reads the mesh's counters
(``parallel.mesh.Mesh.counts``): calls, payload bytes and the largest
payload per kind. Three programs per shape:

* ``sharded_hvp``  — one fused HVP on row-sharded data: exactly one
  all-reduce of the d-vector (the design invariant);
* ``krylov_step``  — one d-space Krylov-CRN step (m = 10) on row-sharded
  data: m + 1 d-vector all-reduces (the gradient and m HVPs) and one
  two-float all-gather per line-search trial;
* ``gram_step``    — one Gram-space step on a row-banded K: m + 1
  all-gathers of the n_pad-vector (one per K-matvec; the JAX step's
  budget is m + 2, its last being the margin re-derivation the port
  leaves out) and no all-reduce.

Beside the counts stand each rank's local bytes: its block's format, and
the K band one matvec streams. The JSON carries no time and no projected
efficiency: the JAX tool's projection used a TPU's rates, and a measured
scaling figure needs a card per rank.

The toy shape runs anywhere (``--device cpu``); the rcv1-like shape
builds the 20480 x 20480 K on every rank and belongs on a card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["SHAPES", "rank_programs", "run", "main"]

M = 10
SHAPES = {"toy": (512, 640, 4096), "rcv1-like": "rcv1-like"}


def _delta(mesh, fn):
    """``fn()``'s collectives: the counters set to zero just before it and
    read just after."""
    mesh.reset_counts()
    fn()
    return mesh.counts_snapshot()


def rank_programs(mesh, shape):
    """One rank's counts for the three programs at ``shape`` (a key of
    ``SHAPES``)."""
    import torch

    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse
    from krylov_crn_tpu_torch.parallel.sharded import (
        build_sharded_dual,
        pad_rowvec,
    )
    from krylov_crn_tpu_torch.solvers.krylov_crn import (
        KrylovState,
        initial_state,
        krylov_step,
    )
    from krylov_crn_tpu_torch.solvers.krylov_gram import (
        GramKrylov,
        gram_krylov_step,
    )
    from krylov_crn_tpu_torch.tools.stress10m_dryrun import _dual_bytes

    A, b = synthetic_logreg(SHAPES[shape], seed=5 if shape == "toy" else 0)
    n, d = A.shape
    x0 = np.full(d, 0.5, np.float32)
    f32 = torch.float32

    sd = build_sharded_dual(A, mesh, dtype=np.float32)
    w = pad_rowvec(np.abs(np.random.default_rng(0).standard_normal(n)), sd)
    v = torch.ones(d, dtype=f32, device=mesh.device)
    hvp = _delta(mesh, lambda: hvp_sparse(sd, w, v))

    loss = LogisticRegression(sd, b)
    state = initial_state(loss, x0, 1e-3, KrylovState)
    step = _delta(mesh, lambda: krylov_step(sd, loss.b_t, state, m=M,
                                            accum_dtype=f32))

    loss_g = LogisticRegression(A, b, dtype=np.float32, device=mesh.device)
    alg = GramKrylov(loss=loss_g, reg_coef=1e-3, subspace_dim=M, tolerance=0,
                     mesh=mesh)
    gstate = alg.init_state(x0, 42)
    gram = _delta(mesh, lambda: gram_krylov_step(alg.gd, gstate, m=M,
                                                 accum_dtype=f32))
    K = alg.gd.K
    return {
        "n": n, "d": d, "nnz": int(A.nnz), "n_pad": alg.gd.n_padded,
        "sharded_hvp": {"collectives": hvp, "d_vector_bytes": 4 * d,
                        "local_format_bytes": _dual_bytes(sd.local),
                        "local_rows": sd.row_counts[mesh.rank],
                        "local_nnz": sd.local.nnz},
        "krylov_step": {"collectives": step, "m": M},
        "gram_step": {"collectives": gram, "m": M,
                      "matvecs_per_step": M + 1,
                      "band_shape": list(K.shape),
                      "local_K_bytes_per_matvec":
                          K.numel() * K.element_size()},
    }


def _rank_main(mesh, shapes):
    return {s: rank_programs(mesh, s) for s in shapes}


def _merge(per_rank, shape):
    """One shape's record: rank 0's counts (every rank must report the
    same), the per-rank local sizes as lists, and the invariants."""
    recs = [r[shape] for r in per_rank]
    out = dict(recs[0])
    for prog in ("sharded_hvp", "krylov_step", "gram_step"):
        if any(r[prog]["collectives"] != out[prog]["collectives"]
               for r in recs[1:]):
            raise RuntimeError(f"scaling_evidence: the ranks count different "
                               f"collectives in {prog} at {shape}")
    for key in ("local_format_bytes", "local_rows", "local_nnz"):
        out["sharded_hvp"][key] = [r["sharded_hvp"][key] for r in recs]
    hvp = out["sharded_hvp"]["collectives"]
    gram = out["gram_step"]["collectives"]
    step = out["krylov_step"]["collectives"]
    out["one_all_reduce_per_hvp"] = (
        hvp["all_reduce"]["calls"] == 1 and hvp["all_gather"]["calls"] == 0
        and hvp["all_reduce"]["bytes"] == 4 * out["d"])
    out["krylov_step_all_reduces_m_plus_1"] = (
        step["all_reduce"]["calls"] == M + 1)
    out["gram_step_within_budget"] = (
        gram["all_gather"]["calls"] == M + 1
        and gram["all_reduce"]["calls"] == 0
        and gram["all_gather"]["bytes"] == (M + 1) * 4 * out["n_pad"])
    return out


def run(shapes, ranks=4, device="cuda:0", timeout=900.0) -> dict:
    from krylov_crn_tpu_torch.parallel.launch import backend_for, run_ranks

    backend = backend_for(device)
    per_rank = run_ranks(_rank_main, ranks, backend, device, timeout,
                         list(shapes))
    card = "cpu"
    if device != "cpu":
        from krylov_crn_tpu_torch.utils.profiling import card_description

        card = card_description()
    out = {"device": card, "ranks": ranks, "backend": backend,
           "ranks_share_one_device": device != "cuda",
           "shapes": {s: _merge(per_rank, s) for s in shapes}}
    out["ok"] = all(rec[k] for rec in out["shapes"].values()
                    for k in ("one_all_reduce_per_hvp",
                              "krylov_step_all_reduces_m_plus_1",
                              "gram_step_within_budget"))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", nargs="+", default=["toy", "rcv1-like"],
                   choices=sorted(SHAPES))
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cuda:0 (ranks share the card, gloo), cuda (a card "
                        "per rank, NCCL) or cpu; default by the card count")
    p.add_argument("--out", default="artifacts/scaling_torch/collectives.json")
    args = p.parse_args(argv)
    device = args.device
    if device is None:
        import torch

        from krylov_crn_tpu_torch.parallel.launch import card_layout

        if not torch.cuda.is_available():
            raise SystemExit("scaling_evidence: needs a CUDA device (or "
                             "--device cpu with --shapes toy)")
        device = card_layout(args.ranks)
    out = run(args.shapes, args.ranks, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
