"""Time the large-n sparse HVP ("stress-1m") on one NVIDIA card.

    python -m krylov_crn_tpu_torch.tools.measure_large_n \\
        [--n 1000000] [--d 1000000] [--nnz 100000000] [--widths] [--out F]

Port of ``tools/measure_large_n.py``. The Gram path needs n^2 memory and
ends near n = 45k; beyond it the one-card path is the sparse d-space one,
whose building block is the fused logistic HVP  A^T (w * (A v)) / n
(``ops/spmv.hvp_sparse``: two CSR products, each a gather, a multiply and
a fixed-order ``segment_reduce``; neither hand-written kernel is on this
path). The tool gives that HVP's time at 1M x 1M with 100M power-law
entries, and with ``--widths`` the gather-width curve that says how much
a multi-vector product would amortize.

* The matrix is made on the card (a ``torch.Generator`` on the device, a
  device sort), as the JAX tool made it on its device: power-law columns
  by an inverse-CDF transform of uniforms, the Zipf-like tail of
  ``data/synthetic.powerlaw_sparse``. The draw repeats some (row, column)
  pairs; the products sum them like any entries (``dual_from_coo``).
* ``bound_ms``, printed beside the measured time, is what the function
  needs over the card's 3.35 TB/s: A and A^T read once at 4 B a value and
  4 B a column index (a million columns fit int32), their row pointers, w
  and v read once and the result written once. The format the port
  streams holds int64 indices (torch sparse CSR as ``data/formats``
  builds it); the same count at 8 B an index is ``format_bound_ms``, and
  each bound has its share.
* Timing: CUDA events over chained calls, v <- Hv / |Hv|
  (``utils/profiling.device_time_per_call`` normalizes between calls).

The 10M x 10M, 1B-entry configuration does not fit one card's format plus
transpose and is a multi-device target. Needs a card; the JSON names it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

__all__ = ["device_powerlaw_coo", "build_device_dual", "measure_hvp",
           "measure_gather_width", "hvp_bound_ms", "result_row", "run", "main"]

NEED_INDEX_BYTES = 4  # a column index below 2^31
FORMAT_INDEX_BYTES = 8  # torch sparse CSR as data/formats builds it: int64


def device_powerlaw_coo(n, d, nnz, seed=0, device=None):
    """(rows, cols, vals) on ``device``, rows sorted (row-sorted COO).

    Columns follow a truncated Pareto rank distribution: for u ~ U(0,1),
    col = floor(exp(u * log(d+1))) - 1 has P(col = k) ~ 1/(k+1), the
    alpha = 1 Zipf tail (close to ``synthetic.powerlaw_sparse``'s
    alpha = 1.1 for bandwidth purposes: what matters to the gather is the
    skewed reuse)."""
    import torch

    from krylov_crn_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, n, (nnz,), generator=gen, device=dev)
    rows = torch.sort(rows).values
    u = torch.rand(nnz, generator=gen, device=dev)
    cols = torch.exp(u * math.log(float(d) + 1.0)).to(torch.int64) - 1
    cols = cols.clamp_(0, d - 1)
    vals = torch.randn(nnz, generator=gen, device=dev)
    return rows, cols, vals


def build_device_dual(n, d, nnz, seed=0, device=None):
    """DualSparse with both orientations built on ``device``."""
    from krylov_crn_tpu_torch.data.formats import dual_from_coo

    rows, cols, vals = device_powerlaw_coo(n, d, nnz, seed=seed,
                                           device=device)
    return dual_from_coo(rows, cols, vals, n, d)


def hvp_bound_ms(n: int, d: int, nnz: int,
                 index_bytes: int = NEED_INDEX_BYTES) -> float:
    """The least time one HVP  A^T (w * (A v)) / n  can take on the card,
    every input read once and the output written once at the published
    rate: A and A^T (a 4 B value and a column index per entry, n + 1 and
    d + 1 row pointers), w (n) and v (d) in, the result (d) out."""
    from krylov_crn_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    nbytes = (2 * nnz * (4 + index_bytes) + index_bytes * (n + d + 2)
              + 4 * (n + 2 * d))
    return nbytes / HBM_BYTES_PER_S * 1e3


def measure_hvp(data, reps=10) -> float:
    """Seconds per HVP (median over chained calls on the card)."""
    import torch

    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse
    from krylov_crn_tpu_torch.utils.profiling import device_time_per_call

    w = torch.ones(data.n, dtype=data.dtype, device=data.device)
    v0 = torch.ones(data.d, dtype=data.dtype, device=data.device)
    ms = device_time_per_call(lambda v: hvp_sparse(data, w, v), v0,
                              reps=reps, warmup=2)
    return ms * 1e-3


def measure_gather_width(nnz, d, widths=(1, 2, 4, 8, 16), seed=1, reps=10):
    """Gathered G elem/s against the row width of the table: how much a
    multi-vector product amortizes the index traffic."""
    import torch

    from krylov_crn_tpu_torch.utils.profiling import device_time_per_call

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, d, (nnz,), generator=gen, device=dev)
    out = {}
    for wdt in widths:
        tbl = torch.randn((d, wdt), generator=gen, device=dev)

        def gather(s, tbl=tbl):
            g = tbl.index_select(0, idx) + s  # (nnz, wdt) gather
            return (g[:, :1].sum() * 1e-20).reshape(1)

        ms = device_time_per_call(gather, torch.zeros((), device=dev),
                                  reps=reps, warmup=2)
        out[wdt] = nnz * wdt / (ms * 1e-3) / 1e9
    return out


def result_row(n, d, nnz, build_s, hvp_s, card) -> dict:
    """The JAX tool's JSON fields, plus the card, the bound by what the
    function needs (int32 indices) and by what the format streams
    (int64), and the share of each that was reached."""
    bound = hvp_bound_ms(n, d, nnz)
    format_bound = hvp_bound_ms(n, d, nnz, FORMAT_INDEX_BYTES)
    return {
        "config": f"{n}x{d}, {nnz} nnz (device power-law)",
        "device": card,
        "device_build_s": round(build_s, 2),
        "hvp_s": round(hvp_s, 6),
        "hvp_gnnz_per_s": round(2 * nnz / hvp_s / 1e9, 4),
        "spmv_gnnz_per_s": round(nnz / (hvp_s / 2) / 1e9, 4),
        "bound_ms": round(bound, 4),
        "share_of_bound": round(bound / (hvp_s * 1e3), 4),
        "format_index_bytes": FORMAT_INDEX_BYTES,
        "format_bound_ms": round(format_bound, 4),
        "share_of_format_bound": round(format_bound / (hvp_s * 1e3), 4),
    }


def run(n, d, nnz, widths=False, seed=0) -> dict:
    """Build the matrix on the card, time the HVP, return the row."""
    import torch

    from krylov_crn_tpu_torch.utils.profiling import card_description

    if not torch.cuda.is_available():
        raise SystemExit("measure_large_n: needs a CUDA device")
    card = card_description()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = build_device_dual(n, d, nnz, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = result_row(n, d, nnz, build_s, measure_hvp(data), card)
    if widths:
        del data
        torch.cuda.empty_cache()
        res["gather_gelem_per_s_by_width"] = {
            str(k): round(v, 4)
            for k, v in measure_gather_width(min(nnz, 50_000_000),
                                             d).items()}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=1_000_000)
    p.add_argument("--nnz", type=int, default=100_000_000)
    p.add_argument("--widths", action="store_true",
                   help="also measure the gather-width amortization curve")
    p.add_argument("--out", help="also write the JSON to this file")
    args = p.parse_args(argv)
    res = run(args.n, args.d, args.nnz, widths=args.widths)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
