"""certify_eval_s.gram: the host's exact fp64 evaluation of every stacked
iterate of the traced Gram solve (``_certify_stacks``' per-iterate loop,
the program's ``gram.certify.eval`` spans), in seconds: certification
without the stacks' fetches."""

from benchmark.spanlog import total_s


def read(ctx):
    return total_s(("gram.certify.eval",))
