"""Driver of SSCN solves: ``SSCN.run(x0, it_max=steps)`` back to back.

One ``SSCN`` instance serves the window, as one user's process would: its
step graphs are captured in the warm solve of the set-up and replayed by
every later solve. Solve i draws its coordinates from its own seed, derived
from the run's seed; the data is the configuration's one dataset.

Kept for the check (one solve of the window, drawn from the seed): every
iterate of its trace and its final value as the program carries it. The
check works every step out again in fp64 from the program's own iterate and
the coordinates the seed gives (``reference.sscn_follow``): the sampled
gradient and Hessian, its eigenpairs, each trial's secular root and step and
the line search's choice, and where the step lands in loss. Following from the program's iterates skips the
program's carried margins, so the final value the program carries is held to
the reference's value of its final iterate on its own. The control
(``control``) puts in the program's place a whole SSCN run of the reference
in fp32 with TF32 products, on the solve's own coordinates.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark import datagen, reference

# the traffic at a CPU test's size: m = 100 for 20 steps
TINY = {"subspace_dim": 100, "steps": 20}


def solve_seed(seed: int, i: int) -> int:
    """The coordinates' seed of solve ``i`` of the window (the warm solve
    is -1, the traced one -2)."""
    return int(np.random.SeedSequence([int(seed), i + 2]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def setup(ctx):
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.solvers.sscn import SSCN

    tr = ctx.traffic
    with ctx.part("data"):
        ctx.A, ctx.b = datagen.make(ctx.config)
    ctx.x0 = np.full(ctx.A.shape[1], float(tr["x0"]))
    with ctx.part("kernel_loads"):
        ctx.load_kernels(tr["kernels"])
    with ctx.part("device_data"):
        ctx.loss = LogisticRegression(ctx.A, ctx.b,
                                      dtype=np.dtype(tr["dtype"]),
                                      device=ctx.device, want_dense=False)
        ctx.loss.data
        ctx.loss.b_t
    ctx.alg = SSCN(loss=ctx.loss, reg_coef=float(tr["reg_coef"]),
                   subspace_dim=int(tr["subspace_dim"]),
                   beta=float(tr["beta"]), ls_max=int(tr["ls_max"]),
                   tolerance=0, label="sscn")
    with ctx.part("warm_up"):
        _solve(ctx, -1, _nospan)


def _nospan(name):
    return contextlib.nullcontext()


def _solve(ctx, i, span):
    alg = ctx.alg
    alg.reset(ctx.loss)
    alg.seeds = [solve_seed(ctx.seed, i)]
    ctx.sync()
    t0 = time.perf_counter()
    with span("run"):
        trace = alg.run(ctx.x0, it_max=int(ctx.traffic["steps"]))
        ctx.sync()
    t1 = time.perf_counter()
    return dict(solve_s=t1 - t0, steps=int(alg.it),
                steps_s=float(trace.ts[-1]),
                further_blocks=int(sum(trace.metrics.get("ls_blocks", []))),
                failed=int(alg.it) != int(ctx.traffic["steps"]))


def solve(ctx, i, span):
    rec = _solve(ctx, i, span)
    if ctx.keep_this(i):
        alg = ctx.alg
        xs = [np.asarray(alg.trace.xs[0], np.float32)]
        xs += [x.cpu().numpy() for x in alg.trace.xs[1:]]
        ctx.kept = dict(solve=i, seed=solve_seed(ctx.seed, i),
                        xs=np.stack(xs),
                        f_final=float(alg.state.value)
                        + float(alg.state.value_lo))
    return rec


def traced(ctx, span):
    _solve(ctx, -2, span)


def release(ctx):
    ctx.alg = None
    ctx.loss = None


def check(ctx, kept=None, steps=None):
    """The numbers compared. ``kept`` is the control's: the reference's
    run in the program's place, with its final value; ``steps`` receives
    each step's readings."""
    kept = ctx.kept if kept is None else kept
    tr = ctx.traffic
    xs = kept["xs"]
    coords = reference.coordinates(kept["seed"], ctx.A.shape[1],
                                   int(tr["subspace_dim"]), len(xs) - 1)
    step_value_err = reference.sscn_follow(
        ctx.A, ctx.b, xs, coords, float(tr["reg_coef"]),
        beta=float(tr["beta"]), ls_max=int(tr["ls_max"]), steps=steps)
    f_ref = reference.value(ctx.A, reference.labels01(ctx.b), xs[-1])
    return {"step_value_err": step_value_err,
            "value_err": abs(kept["f_final"] - f_ref) / abs(f_ref)}


def control(ctx, steps=None):
    """The check with the control in the program's place: a whole SSCN run
    of the reference in fp32 with TF32 products, on the kept solve's own
    coordinates, and its final value in fp32. ``steps`` receives each
    step's readings."""
    tr = ctx.traffic
    seed = ctx.kept["seed"]
    coords = reference.coordinates(seed, ctx.A.shape[1],
                                   int(tr["subspace_dim"]),
                                   len(ctx.kept["xs"]) - 1)
    xs = reference.sscn_solve(ctx.A, ctx.b, ctx.x0, coords,
                              float(tr["reg_coef"]), beta=float(tr["beta"]),
                              ls_max=int(tr["ls_max"]), dtype=np.float32,
                              tf32=True)
    f32 = reference.value(ctx.A, reference.labels01(ctx.b), xs[-1],
                          np.float32)
    return check(ctx, kept=dict(seed=seed, xs=xs, f_final=f32), steps=steps)
