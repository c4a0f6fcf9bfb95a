"""Steps over static buffers, captured as CUDA graphs and replayed.

The JAX package runs a solver step, or a CG solve, as one device program
(``jit`` around a ``lax.while_loop`` or ``lax.scan``). The port's
counterpart on one card is a CUDA graph: the step is captured once over
static state buffers and replayed, so the host launches one graph where
eager PyTorch launches every kernel, and reads nothing in between. The
Gram Krylov step (``solvers/krylov_gram``), the d-space Krylov step
(``solvers/krylov_crn``) and a block of GramCRN's CG iterations
(``solvers/crn_gram``) share ``StepGraphs``.

The kernel wrappers count their launches in Python (``symv.launches``,
``matvec.launches``, ...). A capture launches nothing, so what the
captured step counted is taken back and added at each replay instead: a
replayed run counts what an eager run counts.
"""

from __future__ import annotations

import torch

from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["StepGraphs"]


def _bump(counter, times: int) -> None:
    holder, attr = counter
    setattr(holder, attr, getattr(holder, attr) + times)


class StepGraphs:
    """CUDA graphs of a step that reads its state from the static buffers
    ``state`` and writes it back into them, for one owner on one card (the
    owner holds the graphs; releasing it frees their memory pools). The
    owner is a solver, or for the Gram Krylov step the process
    (``solvers/krylov_gram._GraphCache``).

    ``counters``: the kernel wrappers' counts as ``(holder, attribute)``
    pairs, each an int or a dict of ints (``matvec.shape_launches``);
    ``captures`` and ``replays``: the ``(holder, attribute)`` counts of
    this kind of graph's captures and replays.

    Before a capture the step runs once eagerly on the capture stream, so
    that the kernels' one-time set-up and the per-stream workspaces
    (cuBLAS's, the matvec kernel's tile tickets) happen outside the graph.
    A capture that fails raises: a step that reads the host cannot be
    captured, and nothing here falls back to an eager run."""

    def __init__(self, device, counters, captures, replays):
        self.device = device
        self.counters = tuple(counters)
        self.captures = captures
        self.replays = replays
        self.stream = None
        self.state = None
        self.graphs = {}

    def buffers(self, like) -> bool:
        """Static buffers shaped like ``like`` (a NamedTuple of tensors),
        kept while they fit; new buffers drop every graph (the graphs hold
        the old ones' addresses). True when the buffers are new."""
        if (self.state is not None and type(self.state) is type(like)
                and all(a.shape == b.shape and a.dtype == b.dtype
                        for a, b in zip(self.state, like))):
            return False
        self.graphs.clear()
        self.state = type(like)(*(torch.empty(t.shape, dtype=t.dtype,
                                              device=self.device)
                                  for t in like))
        return True

    def load(self, values):
        """Copy ``values`` (a tuple of tensors like ``state``) into the
        static buffers."""
        for dst, src in zip(self.state, values):
            dst.copy_(src)

    def clone(self):
        """The static buffers' values as new tensors."""
        return type(self.state)(*(t.clone() for t in self.state))

    def _on_capture_stream(self, fn):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def _record(self, body):
        graph = torch.cuda.CUDAGraph()
        # the span opens before the capture begins, so that it can ask
        # whether the stream has drained (a query inside a capture breaks
        # it, and the span then leaves it out)
        with span("graphs.record", host=True):
            with torch.cuda.graph(graph, stream=self.stream):
                body()
        return graph

    def _read_counts(self):
        return [dict(v) if isinstance(v, dict) else v
                for v in (getattr(h, a) for h, a in self.counters)]

    def _take_counts(self, before):
        """Set the counters back to ``before`` and return what they
        counted since, which each replay then adds."""
        delta = []
        for (h, a), was in zip(self.counters, before):
            now = getattr(h, a)
            if isinstance(now, dict):
                delta.append({k: v - was.get(k, 0) for k, v in now.items()
                              if v != was.get(k, 0)})
                now.clear()
                now.update(was)
            else:
                delta.append(now - was)
                setattr(h, a, was)
        return delta

    def _add_counts(self, delta, times: int):
        for (h, a), d in zip(self.counters, delta):
            if isinstance(d, dict):
                counts = getattr(h, a)
                for k, v in d.items():
                    counts[k] = counts.get(k, 0) + v * times
            else:
                setattr(h, a, getattr(h, a) + d * times)

    def capture(self, key, body, warm, replays=None):
        """Capture ``body`` (the step on the static buffers) as the graph
        of ``key``, after ``warm()`` (one eager step that leaves the
        buffers as they are) on the capture stream. Returns the entry,
        (graph, the counts a replay adds, the replay count it bumps:
        ``replays``, a ``(holder, attribute)`` pair, where a kind of graph
        has a count of its own, else the owner's)."""
        with span("graphs.capture"):
            self._on_capture_stream(warm)
            before = self._read_counts()
            graph = self._record(body)
            entry = self.graphs[key] = (graph, self._take_counts(before),
                                        replays or self.replays)
            _bump(self.captures, 1)
        return entry

    def replay(self, entry, times: int = 1):
        """``times`` replays of ``entry``, with their counts."""
        graph, delta, replays = entry
        for _ in range(times):
            graph.replay()
        self._add_counts(delta, times)
        _bump(replays, times)
