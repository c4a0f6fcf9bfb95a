"""folds_per_step.gram: fold kernel launches per replayed Gram step in the
traced solve: the launches that its chunks' replays counted, over their
replays (``fold.launches`` and ``gram_krylov_step.graph_replays`` on the
program's ``gram.replay`` spans). 24 where each of a step's compensated
folds is one launch; nothing where the program's spans count no folds."""

from benchmark.spanlog import records

FOLDS = "fold.launches"
REPLAYS = "gram_krylov_step.graph_replays"


def read(ctx):
    chunks = [r for r in records()
              if r.name == "gram.replay" and FOLDS in r.counts]
    replays = sum(r.counts.get(REPLAYS, 0) for r in chunks)
    if not replays:
        return None
    return sum(r.counts[FOLDS] for r in chunks) / replays
