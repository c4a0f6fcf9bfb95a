"""Named spans of the solvers' work, on the profiler's clock.

The card idles whenever the host works alone: the exact fp64 initial
state, the K build's panel packing, a chunk's reinjection, certification,
SSCN's coordinate draw. A trace of the device shows such a stretch as a
gap, with no name. A span names it:

    from krylov_crn_tpu_torch.utils import spans

    with spans.span("gram.reinject", host=True):
        ...

Spans are on after ``enable()`` or while a torch profiler is active
(checked at each span's entry); there is no other switch. Off, ``span()``
returns one shared object whose ``with`` does nothing: no allocation, no
clock read, no CUDA call. On, a span

* records a profiler op named ``krylov::<name>``, so an active profiler's
  trace holds it beside the kernels (a CPU op: a user-scope
  ``record_function`` would also get a device-side annotation, which a
  reader of the trace's device records takes for device work);
* appends a ``Span`` to an in-memory log (``records()``, at most
  ``MAX_RECORDS``, then counted in ``dropped()``), with its parent, its
  start and end in epoch nanoseconds (the clock on which the profiler
  stamps host events; lengths come from ``perf_counter_ns``, placed on
  that clock by one anchor per outermost span);
* for a ``host`` span (one that queues no device work) on a card, records
  whether the current stream had drained at entry
  (``torch.cuda.current_stream().query()``, which never blocks, and is not
  made while the stream captures a graph): a drained host span is device
  idle time with a name;
* records what each counter in ``counts`` (``(holder, attribute)`` pairs
  of ints, such as ``(symv, "launches")``) counted inside it.

One thread opens spans: the open ones form a single stack.
"""

from __future__ import annotations

import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "span", "enable", "disable", "records", "clear",
           "dropped", "MAX_RECORDS"]

MAX_RECORDS = 65536


class Span:
    """One span of the log. ``parent``: the id of the span it opened in,
    or None; ``drained``: the current stream's state at entry of a host
    span on a card, else None; ``counts``: ``"holder.attribute"`` to the
    count's change."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "host",
                 "drained", "counts")

    def __init__(self, id, parent, name, start_ns, host, drained):
        self.id = id
        self.parent = parent
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.host = host
        self.drained = drained
        self.counts = {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return (f"Span({self.id}, parent={self.parent}, {self.name!r}, "
                f"{self.start_ns}-{self.end_ns}, host={self.host}, "
                f"drained={self.drained}, counts={self.counts})")


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_log: list = []
_open: list = []  # the ids of the open spans, innermost last
_state = {"next_id": 0, "dropped": 0, "anchor": (0, 0)}


def _now() -> int:
    wall, perf = _state["anchor"]
    return wall + time.perf_counter_ns() - perf


def _label(holder, attr) -> str:
    return f"{getattr(holder, '__name__', type(holder).__name__)}.{attr}"


class _Live:
    __slots__ = ("name", "host", "counts", "before", "rec", "op")

    def __init__(self, name, host, counts):
        self.name = name
        self.host = host
        self.counts = counts

    def __enter__(self):
        if not _open:
            _state["anchor"] = (time.time_ns(), time.perf_counter_ns())
        self.op = torch._C._profiler._RecordFunctionFast(
            "krylov::" + self.name)
        self.op.__enter__()
        drained = None
        if (self.host and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            drained = bool(torch.cuda.current_stream().query())
        self.before = [getattr(h, a) for h, a in self.counts]
        rec = self.rec = Span(_state["next_id"], _open[-1] if _open else None,
                              self.name, _now(), self.host, drained)
        _state["next_id"] += 1
        _open.append(rec.id)
        if len(_log) < MAX_RECORDS:
            _log.append(rec)
        else:
            _state["dropped"] += 1
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = _now()
        rec.counts = {_label(h, a): getattr(h, a) - was
                      for (h, a), was in zip(self.counts, self.before)}
        _open.pop()
        self.op.__exit__(*exc)
        return False


def span(name: str, host: bool = False, counts=()):
    """A context manager that records the span ``name`` while spans are
    on (see the module's docstring), else the shared no-op."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Live(name, host, counts)


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _on
    _on = True


def disable() -> None:
    """Record spans again only while a profiler is active."""
    global _on
    _on = False


def records() -> list:
    """The log's spans, in the order they opened."""
    return list(_log)


def clear() -> None:
    """Empty the log and its dropped count."""
    _log.clear()
    _state["dropped"] = 0


def dropped() -> int:
    """Spans left out of the log since it was last cleared: it was full."""
    return _state["dropped"]
