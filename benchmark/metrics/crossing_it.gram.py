"""crossing_it.gram: the certified crossing iteration of the Gram race, from
the program's exact values (``exact_its``/``exact_fs``) against the
benchmark's f*; the mean over the window's solves that crossed."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "crossing_it")
