"""blocks_per_step.sscn: further line-search blocks per SSCN step in the
traced solve: the replays of the further-block graph that each step's span
(``sscn.step``) counted, over the steps."""

from benchmark.spanlog import records

COUNT = "sscn_step.block_replays"


def read(ctx):
    steps = [r for r in records() if r.name == "sscn.step"]
    if not steps:
        return None
    return sum(r.counts.get(COUNT, 0) for r in steps) / len(steps)
