"""draw_ms.sscn: the host's coordinate draw of an SSCN step
(``draw_coordinates``: ``randperm(d)`` on a CPU generator and the pinned
copy, the program's ``sscn.draw`` spans; the upload is left out), the mean
over the traced solve's steps, in ms."""

from benchmark.spanlog import records


def read(ctx):
    draws = [r.seconds for r in records() if r.name == "sscn.draw"]
    return 1e3 * sum(draws) / len(draws) if draws else None
