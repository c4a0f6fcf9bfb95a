"""reinject_s.gram: the host's exact fp64 reinjection at the traced Gram
solve's chunk boundaries, rollbacks included (``_exact_reinject``, the
program's ``gram.reinject`` and ``gram.rollback`` spans; the upload is
left out), in seconds."""

from benchmark.spanlog import total_s


def read(ctx):
    return total_s(("gram.reinject", "gram.rollback"))
