"""From a torch.profiler trace of one solve to the numbers the per-layer
metrics read.

The traced window is the harness's ``bench::solve`` span. Inside it:

* ``busy_s``: the union of every device interval (kernel, copy, fill),
  the ``PAD`` kernels left out; ``window_s`` the span's length;
* ``kernels``: per device-operation name, (launches, seconds);
* ``breakdown``: the 10 device operations that took most time, and the 10
  longest idle gaps of the device, each named by the innermost harness
  span (``bench::<name>``) the host was in at the gap's middle.

Once CUDA graphs have run in a process, a trace can lose its first kernel
records, so every traced window opens with ``PAD`` throwaway sleep kernels
(``pad``), whose records are left out.
"""

from __future__ import annotations

__all__ = ["PAD", "pad", "reduce", "union_gaps"]

PAD = 64
_PAD_NAME = "spin_kernel"


def pad():
    import torch

    for _ in range(PAD):
        torch.cuda._sleep(1)


def union_gaps(intervals, lo, hi):
    """(busy seconds, gaps) of ``intervals`` ((start, end) pairs) clipped
    to [lo, hi]; gaps are (start, end) pairs where none runs."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _span_at(spans, t):
    """The innermost harness span that holds the time ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "outside"


def _records(prof):
    """(device records, host spans) as (start, end, name) in seconds, from
    the profiler's raw kineto events (the harness's own spans, which the
    tracer also shows as device-side annotations, are host spans only)."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        rec = (ev.start_ns(), ev.end_ns(), name)
        if name.startswith("bench::"):
            if ev.device_type() == DeviceType.CPU:
                spans.append(rec[:2] + (name[len("bench::"):],))
        elif ev.device_type() == DeviceType.CUDA and _PAD_NAME not in name:
            device.append(rec)
    # seconds from the earliest record: epoch nanoseconds as floats would
    # round a microsecond kernel's length
    base = min(r[0] for r in device + spans) if device + spans else 0
    return ([((s - base) * 1e-9, (e - base) * 1e-9, n) for s, e, n in device],
            [((s - base) * 1e-9, (e - base) * 1e-9, n) for s, e, n in spans])


def reduce(prof) -> dict:
    device, spans = _records(prof)
    solve = [s for s in spans if s[2] == "solve"]
    if not solve or not device:
        raise RuntimeError(f"profile: {len(device)} device records, "
                           f"{len(solve)} solve spans")
    lo, hi = solve[0][0], solve[0][1]
    busy, gaps = union_gaps([(s, e) for s, e, _ in device], lo, hi)
    kernels = {}
    for s, e, name in device:
        if e <= lo or s >= hi:
            continue
        n, t = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, t + (e - s))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    inner = [s for s in spans if s[2] != "solve"]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": busy,
        "window_s": hi - lo,
        "kernels": kernels,
        "device_records": len(device),
        "breakdown": {
            "device_ops": [[name, t] for name, (_, t) in top],
            "idle_gaps": [[_span_at(inner, (s + e) / 2), e - s]
                          for s, e in longest],
        },
    }
