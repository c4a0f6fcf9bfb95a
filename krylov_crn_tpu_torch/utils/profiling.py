"""Device timing on an NVIDIA card.

Port of ``krylov_crn_tpu/utils/profiling.py``. PyTorch returns before the
card finishes, so a host clock measures the enqueue: kernel times come
from CUDA events around each call. A kernel of tens of microseconds is
shorter than the host's work to launch it, so the card would idle between
the start event and the kernel; a spin kernel queued first holds the card
until every timed call is queued, and each event pair then brackets
device work only. Where the output has the input's shape the calls are
chained and data-dependent (each one's input is the previous output,
normalized), so none can be skipped; the median per call is robust to a
stray slow launch.
"""

from __future__ import annotations

import statistics
from typing import Callable

__all__ = ["device_time_per_call", "alternating_ms", "roofline_fraction",
           "card_description", "HBM_BYTES_PER_S"]

# NVIDIA H100 SXM device memory bandwidth, bytes/s (the card's published
# figure at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12

# ~25 ms at the H100's ~2 GHz clock: longer than the host takes to queue
# a few dozen timed calls
SPIN_CYCLES = 50_000_000


def card_description() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a
    card set below its full limit runs slower under load, so every kept
    number stands beside this line."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def device_time_per_call(fn: Callable, x, reps: int = 25,
                         warmup: int = 3) -> float:
    """Median milliseconds per call of ``fn`` on the card, over ``reps``
    calls each timed with CUDA events; chained, x <- fn(x) / ||fn(x)||,
    when fn keeps the shape of x (a non-square matvec is called on the
    same x each time)."""
    import torch

    def feed(x, y):
        return y / torch.linalg.norm(y) if y.shape == x.shape else x

    for _ in range(warmup):
        x = feed(x, fn(x))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)  # the card waits while the host queues
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        y = fn(x)
        e.record()
        pairs.append((s, e))
        x = feed(x, y)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def alternating_ms(kernel: Callable, plain: Callable, x, reps: int = 25):
    """plain, kernel, kernel, plain on the same card: two lists, the
    kernel's and the plain version's median ms per call of each run
    (two versions compare only within one process on one card)."""
    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if name == "kernel" else plain
        t[name].append(device_time_per_call(fn, x, reps=reps))
    return t["kernel"], t["plain"]


def roofline_fraction(bytes_moved: float, seconds: float,
                      peak: float = HBM_BYTES_PER_S) -> float:
    """Fraction of the device-memory roofline achieved by a bandwidth-bound
    op that moves ``bytes_moved`` in ``seconds``."""
    if seconds <= 0:
        return float("nan")
    return (bytes_moved / seconds) / peak
