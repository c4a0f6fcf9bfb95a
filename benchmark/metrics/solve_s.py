"""solve_s: per solve, from the solve's start as its driver defines it until
the solver returns its result, certification included; the mean over every
whole solve of the window."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "solve_s")
