"""init_state_s.gram: the host's exact fp64 initial state of the traced
Gram solve (``GramKrylov.init_state``'s three SpMVs and its buffer pack,
the program's ``gram.init_state`` span), in seconds."""

from benchmark.spanlog import total_s


def read(ctx):
    return total_s(("gram.init_state",))
