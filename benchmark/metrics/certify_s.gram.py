"""certify_s.gram: a Gram solve's seconds after its last chunk boundary's
timestamp (the exact fp64 host evaluation of every stacked iterate,
``_certify_stacks``, and the run's close); the mean over the window's
solves."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "certify_s")
