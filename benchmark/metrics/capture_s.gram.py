"""capture_s.gram: the host clock around ``GramKrylov.warm_fused``, ending in
a synchronize: a lookup of the race's step graphs in the process's cache
(keyed on K's shape; the set-up's warm solve captured them); the mean over
the window's solves."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "capture_s")
