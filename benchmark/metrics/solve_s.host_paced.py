"""solve_s.host_paced: the whole Gram solve as ``solve_s`` defines it, read
where the host's exact fp64 certification paces it (news20-like); the mean
over the window's solves."""

from benchmark.harness import mean_of


def read(ctx):
    return mean_of(ctx, "solve_s")
