"""crossing_it.dspace: the iteration at which a d-space solve first came
within the traffic's gap of the benchmark's f*, from the fp64 values of the
program's iterates (the driver's ``finish``); the mean over the window's
solves that crossed. A change to the step's line search moves it before
``time_to_gap_s`` shows the change."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "crossing_it")
