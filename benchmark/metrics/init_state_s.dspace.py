"""init_state_s.dspace: the initial state of the traced d-space solve
(``CubicKrylov.init_state``: the product and the value at x0, the
program's ``krylov.init_state`` span), in seconds; None where the program
opens no such span."""

from benchmark.spanlog import total_s


def read(ctx):
    return total_s(("krylov.init_state",))
