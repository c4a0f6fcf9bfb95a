"""The yardstick's numbers: one NVIDIA H100's published peaks and the
operations and bytes of the kernels whose roofline share the benchmark
reads.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense rates, at
the full 700 W; a run prints the card's power limit beside its numbers.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "SYMV_BLOCK", "symv_bytes",
           "eigh_flops", "roofline_share", "kernel_time"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
SYMV_BLOCK = 64  # the upper-triangle kernel's tile edge


def symv_bytes(n_pad: int, itemsize: int = 4) -> int:
    """Bytes one symmetric K-matvec needs from device memory, each once:
    the n(n + 64)/2 entries of K's upper 64 x 64 tiles, x in and y out
    (841.6 MB at n_pad 20480, 820.8 MB at 20224)."""
    return (n_pad * (n_pad + SYMV_BLOCK) // 2 + 2 * n_pad) * itemsize


def eigh_flops(n: int) -> float:
    """Operations of a dense symmetric eigendecomposition with vectors:
    9 n^3 (Golub and Van Loan's symmetric QR with Q accumulated)."""
    return 9.0 * n ** 3


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """Percent of the roofline: the least time the chip could take (the
    larger of flops over the fp32 peak and bytes over the memory peak)
    over the measured time."""
    least = max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
    return 100.0 * least / seconds


def kernel_time(kernels: dict, count_of: str, summed: tuple):
    """(calls, seconds per call) of one call that launches the kernels
    whose names hold one of ``summed``, the calls counted by the launches
    of ``count_of``; None where the trace holds none."""
    calls = sum(n for name, (n, _) in kernels.items() if count_of in name)
    if not calls:
        return None
    secs = sum(t for name, (_, t) in kernels.items()
               if any(k in name for k in summed))
    return calls, secs / calls
