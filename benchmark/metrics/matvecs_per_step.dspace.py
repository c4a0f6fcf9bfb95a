"""matvecs_per_step.dspace: matvec kernel launches per d-space step in the
traced solve: the launches each step's span (``krylov.step``) counted,
over the steps. 2m + 1 = 21 on the dense branch (the gradient's A^T z and
two products per Lanczos step); 0 where the data left it."""

from benchmark.spanlog import records

COUNT = "matvec.launches"


def read(ctx):
    steps = [r for r in records() if r.name == "krylov.step"]
    if not steps:
        return None
    return sum(r.counts.get(COUNT, 0) for r in steps) / len(steps)
