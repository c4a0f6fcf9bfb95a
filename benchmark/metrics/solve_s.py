"""solve_s: per solve, from its start (the K build for Gram, ``Optimizer.run``
for SSCN) until the solver returns its result, certification included; the
mean over every whole solve of the window."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "solve_s")
