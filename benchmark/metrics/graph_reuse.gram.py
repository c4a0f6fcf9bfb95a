"""graph_reuse.gram: the share of the step graphs that ``GramKrylov.warm_fused``
asked for in the traced solve that the program found already recorded, in %:
the reuses over the reuses and captures that its ``gram.warm_fused`` spans
counted (``gram_krylov_step.graph_reuses``, ``.graph_captures``). A program
whose span counts no reuse reads nothing."""

from benchmark.spanlog import records

REUSES = "gram_krylov_step.graph_reuses"
CAPTURES = "gram_krylov_step.graph_captures"


def read(ctx):
    warm = [r for r in records()
            if r.name == "gram.warm_fused" and REUSES in r.counts]
    reused = sum(r.counts[REUSES] for r in warm)
    asked = reused + sum(r.counts.get(CAPTURES, 0) for r in warm)
    if not asked:
        return None
    return 100.0 * reused / asked
