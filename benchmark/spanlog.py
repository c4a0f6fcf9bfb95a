"""The program's span log, as the per-layer metrics read it.

The program records its spans (``krylov_crn_tpu_torch.utils.spans``)
while a torch profiler is active, and only then: in a run of the
benchmark, the log holds the traced solve alone. A span is ``host`` where
it queues no device work; ``drained`` where the card had nothing queued as
it opened. A program without spans has no log, and every reader of it then
reads nothing (None).
"""

from __future__ import annotations

__all__ = ["records", "total_s", "outermost_host", "idle_pct"]


def records() -> list:
    """The traced solve's closed spans, or [] where the program has no
    span log."""
    try:
        from krylov_crn_tpu_torch.utils import spans
    except ImportError:
        return []
    return [r for r in spans.records() if r.end_ns is not None]


def total_s(names):
    """The summed seconds of the spans named in ``names``, or None where
    none was opened."""
    found = [r.seconds for r in records() if r.name in names]
    return sum(found) if found else None


def outermost_host(recs) -> list:
    """The host spans whose parent is not a host span: their times add up
    without counting a stretch twice."""
    host = {r.id for r in recs if r.host}
    return [r for r in recs if r.host and r.parent not in host]


def idle_pct(ctx):
    """The traced solve's device idle time that no drained host span
    names, in % of its window (``busy_s``, ``window_s`` from the profile),
    or None."""
    recs = records()
    if not recs or not ctx.profile:
        return None
    named = sum(r.seconds for r in outermost_host(recs) if r.drained)
    window = ctx.profile["window_s"]
    return 100.0 * (window - ctx.profile["busy_s"] - named) / window
