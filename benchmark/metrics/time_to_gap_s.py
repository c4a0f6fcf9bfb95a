"""time_to_gap_s: per solve, from the solve's start as its driver defines it
to the timestamp of its first certified iterate within the traffic's gap of
the benchmark's f*; the mean over the window's solves that crossed (one
that did not has failed the run)."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "time_to_gap_s")
