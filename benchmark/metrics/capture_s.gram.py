"""capture_s.gram: the host clock around ``GramKrylov.warm_fused``, the capture
of the race's step graphs on the solve's fresh K (the program keys its
graphs on K's address), ending in a synchronize; the mean over the window's
solves."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "capture_s")
