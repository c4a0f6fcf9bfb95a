"""step_ms.sscn: the window's SSCN steps' wall (each solve's ``trace.ts`` at
its last step, from ``Optimizer.run``'s start after the initial state) over
their count, in ms."""


def read(ctx):
    steps = sum(s["steps"] for s in ctx.solves)
    return 1e3 * sum(s["steps_s"] for s in ctx.solves) / steps if steps \
        else None
