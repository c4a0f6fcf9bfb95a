"""The device's idle share of the traced d-space solve, in %: the window
(the harness's solve span) less the union of every device interval
(kernels, copies, fills) from torch.profiler, over the window."""

from benchmark.harness import idle_pct


def read(ctx):
    return idle_pct(ctx)
