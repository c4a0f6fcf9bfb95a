"""The device's idle time in the traced solve that the program's spans do
not name, in % of the window: the idle time (the window less the union of
device records, from torch.profiler) less the length of every host span
(not inside another host span) that opened with the card drained."""

from benchmark.spanlog import idle_pct


def read(ctx):
    return idle_pct(ctx)
