"""build_s.gram: the host clock around ``GramKrylov.init_run`` (the host's
exact initial state and the device K build), ending in a synchronize; the
mean over the window's solves."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "build_s")
