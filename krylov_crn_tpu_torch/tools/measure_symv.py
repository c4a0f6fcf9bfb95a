"""Time the upper-triangle SYMV kernel against ``torch.mv`` on one card.

    python -m krylov_crn_tpu_torch.tools.measure_symv [--n 20480] [--reps 25]

Port of ``tools/measure_symv.py``. K is an exactly symmetric fp32 matrix
made on the card from a seed (B Bᵀ symmetrized bitwise). The product is
bound by device memory: the kernel (``ops/symv.py``, ``csrc/symv.cu``)
reads the n(n+64)/2 entries of the upper 64 x 64 tiles once, ``torch.mv``
(cuBLAS) all n^2, so the speed of light between them is about 2x. Both
are timed with CUDA events over chained calls, in turns (plain, kernel,
kernel, plain: ``utils/profiling.alternating_ms``). The slot entry
(``symv_at``, K's address read from the card) is timed the same way
against the direct one, and their bits compared. Prints one JSON object
that names the card; needs one.
"""

from __future__ import annotations

import argparse
import json

__all__ = ["measure", "main"]


def measure(n: int, reps: int = 25) -> dict:
    import torch

    from krylov_crn_tpu_torch.ops.symv import BLOCK, KSlot, symv, symv_at
    from krylov_crn_tpu_torch.utils.profiling import (
        HBM_BYTES_PER_S,
        alternating_ms,
        card_description,
    )

    if not torch.cuda.is_available():
        raise SystemExit("measure_symv: needs a CUDA device")
    if n % BLOCK:
        raise SystemExit(f"measure_symv: n must be a multiple of {BLOCK}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B = torch.randn((n, n), generator=gen, device=dev) / n ** 0.5
    K = B @ B.T
    del B
    K = (K + K.T).mul_(0.5)  # bitwise symmetric: fp addition commutes
    w = torch.randn(n, generator=gen, device=dev)

    # same fp32 class, another summation order
    y_ref = torch.mv(K, w).double()
    y_sym = symv(K, w).double()
    rel = float(torch.linalg.norm(y_sym - y_ref) / torch.linalg.norm(y_ref))

    kms, pms = alternating_ms(lambda v: symv(K, v), lambda v: torch.mv(K, v),
                              w, reps=reps)
    slot = KSlot(n, K.dtype, dev)
    slot.point(K)
    same_bits = bool(torch.equal(symv_at(slot, w), symv(K, w)))
    ams, dms = alternating_ms(lambda v: symv_at(slot, v),
                              lambda v: symv(K, v), w, reps=reps)
    read = n * (n + BLOCK) // 2 * 4 + 2 * n * 4  # upper tiles, x in, y out
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    return {
        "n": n, "device": card_description(), "rel_err_vs_torch_mv": rel,
        "symv_ms_runs": kms, "torch_mv_ms_runs": pms,
        "symv_ms_min": min(kms), "torch_mv_ms_min": min(pms),
        "symv_gbps_upper_tiles": round(read / min(kms) / 1e6, 1),
        "torch_mv_gbps_full_matrix": round(n * n * 4 / min(pms) / 1e6, 1),
        "bound_ms": bound_ms, "share_of_bound": bound_ms / min(kms),
        "speedup": round(min(pms) / min(kms), 3),
        "symv_at_ms_runs": ams, "symv_direct_ms_runs": dms,
        "symv_at_same_bits": same_bits,
        "symv_at_over_direct": min(ams) / min(dms),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20480)
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, args.reps)))


if __name__ == "__main__":
    main()
