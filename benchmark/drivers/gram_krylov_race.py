"""Driver of the Gram Krylov race: ``GramKrylov`` solves back to back.

A solve is a user's job: a fresh K build (``init_run``), ``warm_fused``
(which finds the race's step graphs in the process's cache, keyed on K's
shape with K read through a slot on the card, so only the set-up's warm
solve captures them), and ``run_fused`` with the traffic's chunk, iteration
budget and certification, which returns after every iterate has been
evaluated exactly in fp64 on the host. Each solve's certified values are
held against the benchmark's own f* (``reference.fstar``, worked out from
the generated data once the window has closed, ``finish``), never the
program's running best. The warm solve of the set-up runs one
iteration of the same calls: every kernel, graph shape and host path, without
the host certification of a whole chunk.

The certified iterates' (gamma, zeta) reps have no public output in the
program: the driver keeps what ``run_fused`` hands its ``_certify_stacks``.

Kept for the check (one solve of the window, drawn from the seed): the
certified iterates' values and their (gamma, zeta) reps, and a sample of K's
rows. The check recomputes those rows of A A^T and the values of the
crossing, the best, the last and three drawn iterates in fp64
(``reference``). The best certified iterate is the solve's answer: past the
crossing, iterates within a chunk may rise again at the fp32 floor. The
control (``control``) puts the reference one precision below fp32 in the
program's place: K's rows as a TF32 product makes them, and the iterates'
values in fp32.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark import datagen, reference

K_ROWS = 64  # rows of K compared
DRAWN_ITS = 3  # drawn iterates compared, beside the crossing, best and last
# the traffic at a CPU test's size: the race runs whole on a tiny problem
TINY = {}


def setup(ctx):
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression

    tr = ctx.traffic
    with ctx.part("data"):
        ctx.A, ctx.b = datagen.make(ctx.config)
    ctx.b01 = reference.labels01(ctx.b)
    ctx.x0 = np.full(ctx.A.shape[1], float(tr["x0"]))
    with ctx.part("kernel_loads"):
        ctx.load_kernels(tr["kernels"])
    ctx.loss = LogisticRegression(ctx.A, ctx.b, dtype=np.dtype(tr["dtype"]),
                                  device=ctx.device, want_dense=False)
    n = ctx.A.shape[0]
    ctx.k_rows = np.sort(ctx.rng(23).choice(n, size=min(K_ROWS, n),
                                            replace=False))
    with ctx.part("warm_up"):
        rec, _, _ = _solve(ctx, 1, _nospan)
    ctx.facts["warm_solve"] = {k: round(rec[k], 4) for k in (
        "build_s", "capture_s", "race_s")}


def _nospan(name):
    return contextlib.nullcontext()


def _solve(ctx, it_max, span):
    from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov

    tr = ctx.traffic
    chunk = int(tr["chunk"])
    alg = GramKrylov(loss=ctx.loss, reg_coef=float(tr["reg_coef"]),
                     subspace_dim=int(tr["subspace_dim"]), tolerance=0,
                     device=ctx.device, label="gram")
    stacks = []
    certify = alg._certify_stacks

    def keep(cert_stacks, metrics):
        stacks.extend(cert_stacks)
        return certify(cert_stacks, metrics)

    alg._certify_stacks = keep
    ctx.sync()
    t0 = time.perf_counter()
    with span("init_run"):
        alg.init_run(ctx.x0, 42)
        alg.initialized = True
        ctx.sync()
    t1 = time.perf_counter()
    with span("warm_fused"):
        alg.warm_fused(chunk=chunk, certify=bool(tr["certify"]))
        ctx.sync()
    t2 = time.perf_counter()
    with span("run_fused"):
        trace = alg.run_fused(ctx.x0, it_max=it_max, chunk=chunk,
                              certify=bool(tr["certify"]))
        ctx.sync()
    t3 = time.perf_counter()
    del alg._certify_stacks  # the wrapper holds alg: no cycle left behind
    m = trace.metrics
    ts_of = dict(zip(trace.its, trace.ts))
    rec = dict(
        solve_s=t3 - t0, build_s=t1 - t0, capture_s=t2 - t1,
        race_s=t3 - t2, its=int(alg.it), rollbacks=len(m["rollback_its"]),
        n_pad=int(alg.gd.K.shape[0]),
        # (iteration, exact fp64 value, seconds from the solve's start) of
        # every certified iterate: ``finish`` finds the crossing in them
        exact=[(int(i), float(f), alg.t_start - t0 + float(ts_of[i]))
               for i, f in zip(m["exact_its"], m["exact_fs"])])
    if m["boundary_its"]:  # none where every chunk was rolled back
        first_b, last_b = m["boundary_its"][0], m["boundary_its"][-1]
        rec.update(first_chunk_s=float(ts_of[first_b]),
                   first_chunk_its=int(first_b),
                   certify_s=t3 - alg.t_start - float(ts_of[last_b]))
    return rec, alg, stacks


def solve(ctx, i, span):
    import torch

    rec, alg, stacks = _solve(ctx, int(ctx.traffic["it_max"]), span)
    if ctx.keep_this(i):
        its = list(alg.trace.metrics["exact_its"])
        gammas, zetas, rep_its = [], [], []
        for first_it, k, (g, z) in stacks:
            gammas.append(g.double().cpu().numpy())
            zetas.append(z.double().cpu().numpy())
            rep_its.extend(range(first_it, first_it + k))
        n = ctx.A.shape[0]
        rows = torch.as_tensor(ctx.k_rows, device=alg.gd.K.device)
        ctx.kept = dict(
            solve=i, its=its,
            fs=[float(v) for v in alg.trace.metrics["exact_fs"]],
            rep_its=rep_its,
            gammas=np.concatenate(gammas) if gammas else np.zeros(0),
            zetas=np.concatenate(zetas) if zetas else np.zeros((0, 0)),
            K_rows=alg.gd.K[rows, :n].double().cpu().numpy())
    return rec


def traced(ctx, span):
    _solve(ctx, int(ctx.traffic["it_max"]), span)


def release(ctx):
    ctx.loss = None


def _crossing(fs, fstar, gap):
    """The index of the first certified value within ``gap`` of ``fstar``,
    or None."""
    return next((j for j, f in enumerate(fs) if f - fstar <= gap), None)


def finish(ctx):
    """Once the window has closed and the program's state is freed: the
    benchmark's f* (not in ``setup_s``), and each solve's crossing of the
    traffic's gap against it. A solve that never crosses has failed."""
    ctx.fstar, facts = reference.fstar(ctx.A, ctx.b, ctx.device)
    ctx.facts["fstar"] = dict(facts, value=ctx.fstar)
    gap = float(ctx.traffic["gap"])
    for rec in ctx.solves:
        its, fs, ts = zip(*rec["exact"]) if rec["exact"] else ((), (), ())
        j = _crossing(fs, ctx.fstar, gap)
        rec.update(crossing_it=None if j is None else its[j],
                   time_to_gap_s=None if j is None else ts[j],
                   best_gap=min(fs) - ctx.fstar if fs else None,
                   failed=j is None)
    if ctx.kept is not None:
        j = _crossing(ctx.kept["fs"], ctx.fstar, gap)
        ctx.kept["crossing"] = None if j is None else ctx.kept["its"][j]


def check(ctx, kept=None, precision=np.float64, k_rows=None):
    """The numbers compared. ``precision`` and ``k_rows`` are the
    control's: the reference in its place at a lower precision."""
    kept = ctx.kept if kept is None else kept
    A, n = ctx.A, ctx.A.shape[0]
    K_rows = kept["K_rows"] if k_rows is None else k_rows
    k_err = float(np.max(np.abs(K_rows - reference.k_rows(A, ctx.k_rows))))
    if not kept["its"]:  # no chunk was kept: nothing was certified
        inf = float("inf")
        return {"k_err": k_err, "cert_err": inf, "best_gap": inf}
    rep_at = {it: j for j, it in enumerate(kept["rep_its"])}
    f_at = dict(zip(kept["its"], kept["fs"]))
    best = min(zip(kept["fs"], kept["its"]))[1]
    pick = {kept["its"][-1], best}
    if kept["crossing"] is not None:
        pick.add(kept["crossing"])
    pick.update(int(v) for v in ctx.rng(29).choice(
        kept["its"], size=min(DRAWN_ITS, len(kept["its"])), replace=False))
    cert, f_ref = [], {}  # the crossing's certified value is among these
    for it in sorted(pick):
        j = rep_at[it]
        f_ref[it] = reference.value_rep(A, ctx.b01, ctx.x0,
                                        kept["gammas"][j],
                                        kept["zetas"][j, :n])
        f_prog = f_at[it] if precision == np.float64 else \
            reference.value_rep(A, ctx.b01, ctx.x0, kept["gammas"][j],
                                kept["zetas"][j, :n], dtype=precision)
        cert.append(abs(f_prog - f_ref[it]) / abs(f_ref[it]))
    return {"k_err": k_err, "cert_err": max(cert),
            "best_gap": f_ref[best] - ctx.fstar}


def control(ctx, steps=None):
    """The check with the control in the program's place: K's rows as a
    TF32 product makes them (inputs rounded to a 10-bit mantissa, fp32
    sums), and the kept iterates' values in fp32. A race has no per-step
    readings: ``steps`` is left empty."""
    rows = reference.k_rows_tf32(ctx.A, ctx.k_rows)
    return check(ctx, precision=np.float32, k_rows=rows)
