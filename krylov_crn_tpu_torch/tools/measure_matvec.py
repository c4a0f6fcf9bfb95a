"""Time the dense matvec y = K w on one NVIDIA card.

    python -m krylov_crn_tpu_torch.tools.measure_matvec [n ...]

Port of ``tools/measure_matvec.py``, which timed the Pallas tile kernel
against XLA's ``K @ w`` on the TPU. Four rows per n (default 20480), K an
(n, n) normal matrix made on the card from a seed:

* ``kernel_fp32``  the hand-written kernel (``ops/matvec.py``), fp32 K;
* ``kernel_bf16``  the same kernel on bf16 K: fp32 x, fp32 accumulation;
* ``torch_fp32``   ``torch.mv`` (cuBLAS) on fp32 K and x;
* ``torch_bf16``   ``torch.mv`` on bf16 K *and bf16 x* (x is rounded to
  bf16 there, unlike in the kernel).

Each row: median ms per call (CUDA events over chained calls,
``utils/profiling``), GB/s of K read, and the share of the card's
published 3.35 TB/s. Needs a card; prints the card's name first.
"""

from __future__ import annotations

import sys

__all__ = ["measure", "main"]


def measure(n: int, reps: int = 25) -> list[dict]:
    """The four rows at (n, n), as dicts (name, ms, gbps, roofline)."""
    import torch

    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.utils.profiling import (
        device_time_per_call,
        roofline_fraction,
    )

    if not torch.cuda.is_available():
        raise SystemExit("measure_matvec: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    K32 = torch.randn((n, n), generator=gen, device=dev)
    w = torch.randn(n, generator=gen, device=dev)
    K16 = K32.to(torch.bfloat16)
    rows = []
    for name, fn, x, itemsize in (
            ("kernel_fp32", lambda v: matvec(K32, v), w, 4),
            ("kernel_bf16", lambda v: matvec(K16, v), w, 2),
            ("torch_fp32", lambda v: torch.mv(K32, v), w, 4),
            ("torch_bf16", lambda v: torch.mv(K16, v),
             w.to(torch.bfloat16), 2)):
        ms = device_time_per_call(fn, x, reps=reps)
        nbytes = n * n * itemsize
        rows.append(dict(name=name, n=n, ms=ms, gbps=nbytes / ms / 1e6,
                         roofline=roofline_fraction(nbytes, ms * 1e-3)))
    return rows


def main(argv=None):
    import torch

    ns = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [20480]
    for i, n in enumerate(ns):
        rows = measure(n)  # raises without a card
        if i == 0:
            print(f"device {torch.cuda.get_device_name(0)}")
            print("torch_bf16 rounds x to bf16; the kernel keeps x in fp32")
        for r in rows:
            print(f"n={n} {r['name']:12s} {r['ms']:8.4f} ms  "
                  f"{r['gbps']:7.1f} GB/s  roofline {r['roofline']:6.1%}")


if __name__ == "__main__":
    main()
