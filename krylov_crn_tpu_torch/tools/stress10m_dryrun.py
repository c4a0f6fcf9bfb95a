"""Structural exercise of the stress-10m configuration over a mesh.

    python -m krylov_crn_tpu_torch.tools.stress10m_dryrun \\
        [--n 10000000] [--d 10000000] [--nnz 100000000] [--ranks 4] \\
        [--device cuda:0|cuda|cpu] [--out FILE.json]

Port of ``tools/stress10m_dryrun.py``. stress-10m (10M x 10M, 1B entries)
is a multi-device target: its format plus transpose does not fit one
card. What one card can exercise is the whole row-sharded code path at
the REAL row and column dimensions with a tenth of the entries: every
rank makes its own rows on its device (a seeded device generator and a
device sort, as ``tools/measure_large_n`` does for stress-1m; no rank
holds another's rows during the HVP), the blocks form a ``ShardedDual``, one fused HVP
runs through ``ops/spmv.hvp_sparse`` with exactly one all-reduce of the
d-vector, and rank 0 holds the result against a single-device
``dual_from_coo`` HVP of the same entries. The JSON also gives each
rank's device bytes at this size and scaled to the 1B-entry target.

``--device cuda:0`` (the default when the host has fewer cards than
ranks) puts all ranks on one card over gloo: the ranks' contexts then
time-slice the card, so ``hvp_s`` there is a correctness run's time, not
a scaling figure. ``--device cuda`` gives each rank a card over NCCL.
Small sizes run on the CPU (``--device cpu``) for tests.
"""

from __future__ import annotations

import argparse
import json
import os
import time

__all__ = ["rank_entries", "rank_block", "whole_dual", "run", "main"]

FULL_NNZ = 1_000_000_000
REL_TOL = 1e-5  # fp32 segment sums in two summation orders


def rank_entries(rank, world, n, d, nnz, seed, device):
    """(rows, cols, vals) of rank ``rank``'s block, row-sorted: n / world
    rows with local ids and nnz / world entries from a seed of its own,
    the columns power-law as in ``measure_large_n.device_powerlaw_coo``
    (col = floor(exp(u log(d+1))) - 1). The transform runs in fp64: at
    d = 10M an fp32 exponential is several columns off, and any process
    must be able to draw a block again exactly (rank 0 does, to check the
    sharded HVP), which a last-digit difference near a whole number
    would break."""
    import math

    import torch

    k = nnz // world
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + rank)
    rows = torch.randint(0, n // world, (k,), generator=gen, device=device)
    rows = torch.sort(rows).values
    u = torch.rand(k, generator=gen, device=device, dtype=torch.float64)
    cols = torch.exp(u * math.log(float(d) + 1.0)).to(torch.int64) - 1
    cols = cols.clamp_(0, d - 1)
    vals = torch.randn(k, generator=gen, device=device)
    return rows, cols, vals


def rank_block(mesh, n, d, nnz, seed=0, entries=None):
    """This rank's ``ShardedDual``, made where it lies (from ``entries``,
    this rank's ``rank_entries``, when the caller has drawn them)."""
    import torch

    from krylov_crn_tpu_torch.data.formats import dual_from_coo
    from krylov_crn_tpu_torch.parallel.sharded import ShardedDual

    if n % mesh.world or nnz % mesh.world:
        raise ValueError(f"stress10m: {mesh.world} ranks must divide n = {n} "
                         f"and nnz = {nnz}")
    n_l = n // mesh.world
    rows, cols, vals = entries or rank_entries(mesh.rank, mesh.world, n, d,
                                               nnz, seed, mesh.device)
    local = dual_from_coo(rows, cols, vals, n_l, d)
    return ShardedDual(local=local,
                       mask=torch.ones(n_l, dtype=vals.dtype,
                                       device=mesh.device),
                       n=n, d=d, nnz=nnz, n_local=n_l,
                       row_counts=(n_l,) * mesh.world, mesh=mesh)


def _checksum(rows, cols, vals) -> list:
    """Sums that pin a block's entries: a rank's own and rank 0's
    regeneration of them must agree exactly."""
    return [int(rows.sum()), int(cols.sum()), float(vals.double().sum())]


def whole_dual(world, n, d, nnz, seed, device, checksums=None):
    """The single-device ``DualSparse`` of all ranks' entries (the blocks
    stacked in rank order stay row-sorted); ``checksums`` collects each
    regenerated block's ``_checksum``."""
    import torch

    from krylov_crn_tpu_torch.data.formats import dual_from_coo

    parts = [rank_entries(r, world, n, d, nnz, seed, device)
             for r in range(world)]
    if checksums is not None:
        checksums.extend(_checksum(*p) for p in parts)
    rows = torch.cat([p[0] + r * (n // world) for r, p in enumerate(parts)])
    cols = torch.cat([p[1] for p in parts])
    vals = torch.cat([p[2] for p in parts])
    del parts
    return dual_from_coo(rows, cols, vals, n, d)


def _dual_bytes(local) -> int:
    """Device bytes of one block's format: values, column indices and row
    pointers of both orientations."""
    return sum(t.numel() * t.element_size()
               for m in (local.a, local.at)
               for t in (m.values(), m.col_indices(), m.crow_indices()))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_run(mesh, n, d, nnz, seed, check):
    import torch

    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse

    dev = mesh.device
    t0 = time.perf_counter()
    entries = rank_entries(mesh.rank, mesh.world, n, d, nnz, seed, dev)
    checksum = _checksum(*entries)
    sd = rank_block(mesh, n, d, nnz, seed, entries)
    del entries
    _sync(dev)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    w = torch.rand(n, generator=gen, device=dev)
    v = torch.randn(d, generator=gen, device=dev)
    n_l = sd.n_local
    w_l = w[mesh.rank * n_l:(mesh.rank + 1) * n_l].clone()
    hvp_sparse(sd, w_l, v)  # warm
    mesh.reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    got = hvp_sparse(sd, w_l, v)
    _sync(dev)
    hvp_s = time.perf_counter() - t0
    counts = mesh.counts_snapshot()
    out = dict(rank=mesh.rank, build_s=build_s, hvp_s=hvp_s,
               counts=counts, bytes_local=_dual_bytes(sd.local),
               nnz_local=sd.local.nnz, finite=bool(torch.isfinite(got).all()),
               checksum=checksum + [float(w.double().sum()),
                                    float(v.double().sum())])
    if check and mesh.rank == 0:
        # the same entries on one device, no collective: rank 0 alone
        del sd
        out["regenerated"] = []
        whole = whole_dual(mesh.world, n, d, nnz, seed, dev,
                           out["regenerated"])
        want = hvp_sparse(whole, w, v).double()
        out["rel_err_vs_single_device"] = float(
            torch.linalg.norm(got.double() - want) / torch.linalg.norm(want))
    return out


def run(n, d, nnz, ranks=4, device="cuda:0", seed=0, check=True,
        timeout=900.0) -> dict:
    """Run the dry run in ``ranks`` ranks and return the JSON record."""
    from krylov_crn_tpu_torch.parallel.launch import backend_for, run_ranks
    from krylov_crn_tpu_torch.tools.measure_large_n import hvp_bound_ms

    backend = backend_for(device)
    res = run_ranks(_rank_run, ranks, backend, device, timeout, n, d, nnz,
                    seed, check)
    card = "cpu"
    if device != "cpu":
        from krylov_crn_tpu_torch.utils.profiling import card_description

        card = card_description()
    ar = [r["counts"]["all_reduce"] for r in res]
    per_rank = max(r["bytes_local"] for r in res)
    # the entries scale with nnz (a 4 B value and an int64 column index in
    # each orientation), the row pointers do not
    entries = 2 * (4 + 8) * max(r["nnz_local"] for r in res)
    at_full = (per_rank - entries) + entries * (FULL_NNZ / nnz)
    out = {
        "config": f"{n}x{d}, {nnz} nnz (device power-law, {ranks} row "
                  f"blocks; structural dry run of the {FULL_NNZ}-nnz "
                  f"stress-10m)",
        "device": card, "ranks": ranks, "backend": backend,
        "ranks_share_one_device": device != "cuda",
        "nnz_local": [r["nnz_local"] for r in res],
        "bytes_per_rank": per_rank,
        "bytes_per_rank_at_1B_nnz": int(at_full),
        "fits_80GB_at_1B_nnz": at_full < 80e9,
        "all_reduces_per_hvp": ar[0]["calls"],
        "all_reduce_bytes_per_hvp": ar[0]["bytes"],
        "all_gathers_per_hvp": res[0]["counts"]["all_gather"]["calls"],
        "shard_build_s": round(max(r["build_s"] for r in res), 3),
        "hvp_s": round(max(r["hvp_s"] for r in res), 6),
        "hvp_bound_ms_one_device": round(hvp_bound_ms(n, d, nnz), 4),
        "rel_err_vs_single_device": res[0].get("rel_err_vs_single_device"),
        # rank 0 regenerated every block from its seed: the same entries,
        # and the same w and v on every rank
        "same_entries": (not check or [r["checksum"][:3] for r in res]
                         == res[0]["regenerated"])
        and all(r["checksum"][3:] == res[0]["checksum"][3:] for r in res),
    }
    out["ok"] = bool(
        all(a["calls"] == 1 and a["bytes"] == 4 * d for a in ar)
        and out["all_gathers_per_hvp"] == 0
        and all(r["finite"] for r in res) and out["same_entries"]
        and (not check or out["rel_err_vs_single_device"] < REL_TOL)
        and out["fits_80GB_at_1B_nnz"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=10_000_000)
    p.add_argument("--d", type=int, default=10_000_000)
    p.add_argument("--nnz", type=int, default=100_000_000)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="cuda:0 (ranks share the card, gloo), cuda (a card "
                        "per rank, NCCL) or cpu; default by the card count")
    p.add_argument("--out",
                   default="artifacts/stress/stress10m_dryrun_torch.json")
    args = p.parse_args(argv)
    device = args.device
    if device is None:
        import torch

        from krylov_crn_tpu_torch.parallel.launch import card_layout

        if not torch.cuda.is_available():
            raise SystemExit("stress10m_dryrun: needs a CUDA device (or "
                             "--device cpu at a small size)")
        device = card_layout(args.ranks)
    out = run(args.n, args.d, args.nnz, args.ranks, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
