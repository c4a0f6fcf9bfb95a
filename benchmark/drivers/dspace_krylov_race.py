"""Driver of d-space Krylov CRN solves: ``CubicKrylov.run(x0, it_max)`` back
to back.

One ``CubicKrylov`` instance serves the window, as one user's process
would: its step graph is captured in the warm solve of the set-up and
replayed by every later solve, each ``alg.reset(loss)`` and then
``alg.run`` to the traffic's stopping rule (a step shorter than
``tolerance``, or ``it_max`` steps). The loss keeps the program's own
dense rule: at d <= 2048 the data keeps dense copies of A and A^T, and
every product of the step goes through the matvec kernel.

A solve's clock runs from before ``alg.run`` to its return, synchronised;
its iterates come to the host after the clock stops. The benchmark, not
the program, decides the crossing: ``finish`` works out the fp64 value of
each iterate (once per distinct bit pattern) against ``reference.fstar``.
The run loop stamps ``trace.ts[k]`` once step k is launched, and reads
step k's state (``update_trace``'s blocking read) before it stamps
``trace.ts[k + 1]``; so iterate k's time is ``ts[k + 1]`` from the
solve's start, or the solve's end for the last iterate, never earlier
than the step's end. A solve that never crosses has failed.

Kept for the check (one solve of the window, drawn from the seed): its
iterates and the value pair the program carries at the last one. The
check works every step out again in fp64 from the program's own iterate
(``reference_dspace.dspace_follow``) and takes the fp64 value of the best
iterate less f*. The control (``control``) puts a whole
``reference_dspace.dspace_solve`` in fp32 with TF32 products in the
program's place.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark import datagen, reference, reference_dspace

# the traffic at a CPU test's size: the solve runs whole on the tiny problem
TINY = {}


def setup(ctx):
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov

    tr = ctx.traffic
    with ctx.part("data"):
        ctx.A, ctx.b = datagen.make(ctx.config)
    ctx.x0 = np.full(ctx.A.shape[1], float(tr["x0"]))
    with ctx.part("kernel_loads"):
        ctx.load_kernels(tr["kernels"])
    with ctx.part("device_data"):
        ctx.loss = LogisticRegression(ctx.A, ctx.b,
                                      dtype=np.dtype(tr["dtype"]),
                                      device=ctx.device)
        data = ctx.loss.data
        ctx.loss.b_t
    # (rows, columns, leading dimension) of each dense copy the products
    # read: matvec_roofline's bytes
    ctx.matvec_shapes = [(M.shape[0], M.shape[1], M.stride(0))
                         for M in (data.dense, data.dense_t) if M is not None]
    ctx.facts["matvec_shapes"] = ctx.matvec_shapes
    ctx.alg = CubicKrylov(
        loss=ctx.loss, reg_coef=float(tr["reg_coef"]),
        subspace_dim=int(tr["subspace_dim"]),
        solver_eps=float(tr["solver_eps"]), beta=float(tr["beta"]),
        solver_it_max=int(tr["solver_it_max"]), ls_max=int(tr["ls_max"]),
        tolerance=float(tr["tolerance"]), label="krylov")
    with ctx.part("warm_up"):
        _solve(ctx, _nospan)


def _nospan(name):
    return contextlib.nullcontext()


def _solve(ctx, span):
    import torch

    alg = ctx.alg
    alg.reset(ctx.loss)
    ctx.sync()
    t0 = time.perf_counter()
    with span("run"):
        trace = alg.run(ctx.x0, it_max=int(ctx.traffic["it_max"]))
        ctx.sync()
    t1 = time.perf_counter()
    xs = [np.asarray(trace.xs[0], np.float32)]
    if len(trace.xs) > 1:
        xs += list(torch.stack(trace.xs[1:]).cpu().numpy())
    # iterate k was complete on the card by done_s[k] (the module's doc)
    done_s = [alg.t_start - t0 + float(t) for t in trace.ts[1:]] + [t1 - t0]
    return dict(solve_s=t1 - t0, steps=int(alg.it),
                consecutive=list(trace.its) == list(range(len(xs))),
                xs=xs, done_s=done_s)


def solve(ctx, i, span):
    rec = _solve(ctx, span)
    if ctx.keep_this(i):
        st = ctx.alg.state
        ctx.kept = dict(solve=i, xs=np.stack(rec["xs"]),
                        f_carried=float(st.value) + float(st.value_lo))
    return rec


def traced(ctx, span):
    _solve(ctx, span)


def release(ctx):
    ctx.alg = None
    ctx.loss = None


def finish(ctx):
    """Once the window has closed and the program's state is freed: the
    benchmark's f* (not in ``setup_s``), the fp64 value of every iterate
    of every solve, and each solve's crossing of the traffic's gap. A
    solve that never crosses, or whose iterates are not every one of its
    steps, has failed."""
    ctx.fstar, facts = reference.fstar(ctx.A, ctx.b, ctx.device)
    ctx.facts["fstar"] = dict(facts, value=ctx.fstar)
    b01 = reference.labels01(ctx.b)
    values = {}

    def f_of(x):
        key = x.tobytes()
        if key not in values:
            values[key] = reference.value(ctx.A, b01, x)
        return values[key]

    gap = float(ctx.traffic["gap"])
    for rec in ctx.solves:
        fs = [f_of(x) for x in rec.pop("xs")]
        j = next((k for k, f in enumerate(fs) if f - ctx.fstar <= gap), None)
        rec.update(crossing_it=j,
                   time_to_gap_s=None if j is None else rec["done_s"][j],
                   best_gap=min(fs) - ctx.fstar,
                   failed=j is None or not rec["consecutive"])
    if ctx.kept is not None:
        ctx.kept["fs"] = [f_of(x) for x in ctx.kept["xs"]]
    ctx.facts["distinct_iterates"] = len(values)


def check(ctx, kept=None, steps=None):
    """The numbers compared, and ``value_err``, read but not compared.
    ``kept`` is the control's: the reference's run in the program's place,
    with its final value; ``steps`` receives each step's readings."""
    kept = ctx.kept if kept is None else kept
    tr = ctx.traffic
    xs = kept["xs"]
    b01 = reference.labels01(ctx.b)
    fs = kept.get("fs") or [reference.value(ctx.A, b01, x) for x in xs]
    step_value_err = reference_dspace.dspace_follow(
        ctx.A, ctx.b, xs, float(tr["reg_coef"]), m=int(tr["subspace_dim"]),
        beta=float(tr["beta"]), ls_max=int(tr["ls_max"]),
        ulp_eps=float(np.finfo(np.dtype(tr["dtype"])).eps), steps=steps)
    return {"step_value_err": step_value_err,
            "best_gap": min(fs) - ctx.fstar,
            "value_err": abs(kept["f_carried"] - fs[-1]) / abs(fs[-1])}


def control(ctx, steps=None):
    """The check with the control in the program's place: a whole run of
    the reference in fp32 with TF32 products, stopped by the traffic's
    rule, and its final value in fp32. ``steps`` receives each step's
    readings."""
    tr = ctx.traffic
    xs = reference_dspace.dspace_solve(
        ctx.A, ctx.b, ctx.x0, float(tr["reg_coef"]),
        m=int(tr["subspace_dim"]), beta=float(tr["beta"]),
        ls_max=int(tr["ls_max"]), it_max=int(tr["it_max"]),
        tolerance=float(tr["tolerance"]), dtype=np.float32, tf32=True)
    f32 = reference.value(ctx.A, reference.labels01(ctx.b), xs[-1],
                          np.float32)
    return check(ctx, kept=dict(xs=xs, f_carried=f32), steps=steps)
