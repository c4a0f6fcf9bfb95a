"""step_ms.dspace: the d-space step's wall in the traced solve, in ms: the
mean distance between the starts of consecutive ``krylov.step`` spans of
one solve (a ``krylov.init_state`` span opens each solve). That is one
replay of the step graph and the run loop's host reads after it."""

from benchmark.spanlog import records


def read(ctx):
    gaps, last = [], None
    for r in records():
        if r.name == "krylov.init_state":
            last = None
        elif r.name == "krylov.step":
            if last is not None:
                gaps.append(r.start_ns - last)
            last = r.start_ns
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
