"""Figure-2 grid on one NVIDIA card: the convergence curves as JSON (+ PDF).

    python -m krylov_crn_tpu_torch.tools.run_figure2 --dataset all
    python -m krylov_crn_tpu_torch.tools.run_figure2 --dataset rcv1-like \\
        --leg cpu-fp64 --it_max 50

Port of ``tools/run_figure2.py``: the reference's Figure-2 experiment grid
(cubic_newton.sh:3-8) on the synthetic stand-ins shaped like the LIBSVM
datasets, recorded as gap-vs-iteration / gap-vs-time curves under
``artifacts/figure2_torch/`` (the JAX package's ``artifacts/figure2/`` is
never written).

Two legs, merged into one JSON per dataset:

  * ``h100-fp32`` (default): the fp32 solvers on the card: CRN, SSCN for
    every grid dimension, Krylov CRN m=10 and the 5x-budget m=20
    benchmark run that defines the empirical f* (reference protocol,
    cubic_newton.py:71-73,109-111,140). The JSON names the card and its
    power limit;
  * ``--leg cpu-fp64``: the same solvers in fp64 on the CPU, the
    verification run showing that the fp32 curves are no artifact of the
    card's numerics.

The shared f* of the gap curves is the minimum over every f value any leg
observed, folded across legs through the merged JSON. Every committed
final gap is fp64-grade: exact host re-evaluations for fp32 runs.

Left out: the JAX tool's ``--with-reference`` leg (``run_reference``),
which runs the upstream scipy implementation in-process and needs its
sources beside the repository. SSCN draws its coordinates from the port's
seeded CPU generator, so its curves are another sample than the JAX
package's.

``run_dataset`` needs no matplotlib; ``plot_dataset`` draws a merged JSON.
``main`` does both and skips the figures, saying so, where matplotlib is
not installed. ``run_crn`` / ``run_krylov`` / ``run_sscn`` run one
algorithm each, so a caller can drive any part of the grid.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

GRID = {
    # dataset -> (it_max, sscn_dims): the full reference grid of
    # cubic_newton.sh:3-8 (w8a runs the script's default m=10,
    # cubic_newton.py:26-27); m=1000 on news20 is a panel width nothing
    # else exercises
    "w8a-like": (100, [10]),
    "rcv1-like": (50, [10, 50, 100, 500]),
    "news20-like": (50, [10, 50, 500, 1000]),
}
REF_T_MAX = 240.0
LEGS = {"h100-fp32": (np.float32, None), "cpu-fp64": (np.float64, "cpu")}
OUT_DIR = "artifacts/figure2_torch"


def build_problem(name, seed=0):
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg(name, seed=seed)
    x0 = np.ones(A.shape[1]) * 0.5
    return A, b, x0


def curve_of(trace):
    """Curve dict; fused runs additionally carry the exact fp64
    host-verified values (metrics[exact_its/exact_fs]): the
    full-resolution fp32 device readings have ~1e-6 noise and must not
    define f* or the committed final gaps (noisy readings dip below the
    exact f* and plot a false machine-precision floor)."""
    fs = [float(v) for v in trace.loss_vals]
    out = {"its": [int(i) for i in trace.its],
           "ts": [float(t) for t in trace.ts],
           "fs": fs}
    m = getattr(trace, "metrics", {}) or {}
    if m.get("exact_its"):
        out["exact_its"] = [int(i) for i in m["exact_its"]]
        out["exact_fs"] = [float(v) for v in m["exact_fs"]]
        it_to_t = dict(zip(trace.its, trace.ts))
        out["exact_ts"] = [float(it_to_t.get(i, float("nan")))
                           for i in m["exact_its"]]
    return out


def _host_f64(x):
    """An iterate (tensor on any device, or array) as host fp64."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def certify_iterate_curve(trace, A, b, l2=0.0):
    """Exact fp64 host re-evaluation of stored iterates (solvers that
    keep x in their trace: the d-space path and SSCN). Fills
    metrics[exact_its/exact_fs] so the committed curves and final gaps
    are fp64-verified rather than fp32 device readings. One host SpMV per
    checkpoint."""
    b01 = (np.asarray(b) > 0).astype(np.float64)
    exact_its, exact_fs = [], []
    for it, x in zip(trace.its, trace.xs):
        x64 = _host_f64(x)
        if x64.ndim != 1:
            continue
        m = A.dot(x64)
        ls = np.where(m < 0, m - np.log1p(np.exp(m)),
                      -np.log1p(np.exp(-m)))
        v = float(np.mean((1.0 - b01) * m - ls))
        if l2:
            v += 0.5 * l2 * float(x64 @ x64)
        exact_its.append(int(it))
        exact_fs.append(v)
    if exact_fs:
        trace.metrics["exact_its"] = exact_its
        trace.metrics["exact_fs"] = exact_fs
    return min(exact_fs) if exact_fs else np.inf


def use_gram(n, dim) -> bool:
    """The Gram path where the dense n x n K fits and beats sparse
    products, the d-space path otherwise (the CLI's rule)."""
    return n <= 45056 and n <= 4 * dim


def make_loss(A, b, dtype, device=None):
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression

    dim = A.shape[1]
    return LogisticRegression(A, b, dtype=dtype, device=device,
                              want_dense=None if dim < 500 else False)


def _run_stored(alg, x0, it_max, t_max, A_host, b):
    """A step-for-step run that keeps its iterates, certified in fp64."""
    alg.run(x0=np.asarray(x0), it_max=it_max, t_max=t_max)
    alg.compute_loss_of_iterates()
    certify_iterate_curve(alg.trace, A_host, b)
    return curve_of(alg.trace)


def run_crn(loss, b, x0, it_max, gram, t_max=REF_T_MAX):
    """The CRN leg: GramCRN on the Gram path, else CubicNewton ("full"
    below d = 500, CG above). Returns (curve, optimizer)."""
    x0 = np.asarray(x0)
    if gram:
        from krylov_crn_tpu_torch.solvers.crn_gram import GramCRN

        crn = GramCRN(loss=loss, reg_coef=1e-3, tolerance=1e-8, label="CRN",
                      device=loss.device)
        crn.warm(x0)
        crn.run(x0=x0, it_max=it_max, t_max=t_max)
        crn.compute_loss_of_iterates()
        return curve_of(crn.trace), crn
    from krylov_crn_tpu_torch.solvers.crn import CubicNewton

    crn = CubicNewton(loss=loss, reg_coef=1e-3, tolerance=1e-8,
                      cubic_solver="full" if loss.dim < 500 else "CG",
                      label="CRN")
    crn.warm(x0)
    return _run_stored(crn, x0, it_max, t_max, loss.A_host, b), crn


def run_krylov(loss, b, x0, it_max, gram, m=10, gram_data=None, label=None,
               warm=True, t_max=REF_T_MAX):
    """One Krylov CRN run. Gram path: fused, certify=True, so every
    iterate is exact-evaluated after the run and the curve is
    fp64-verified at per-iteration resolution; ``gram_data`` shares a
    built K. d-space path: step for step within ``t_max``, iterates
    certified. Returns (curve, optimizer)."""
    label = label or f"Krylov CRN (m={m})"
    if gram:
        from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov

        kry = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=m,
                         tolerance=0, label=label, gram_data=gram_data,
                         device=None if gram_data is not None
                         else loss.device)
        tr = kry.run_fused(x0, it_max=it_max, certify=True)
        return curve_of(tr), kry
    from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov

    kry = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=m, tolerance=0,
                      label=label)
    if warm:
        kry.warm(np.asarray(x0))
    return _run_stored(kry, x0, it_max, t_max, loss.A_host, b), kry


def run_sscn(loss, b, x0, it_max, m, t_max=REF_T_MAX):
    """One SSCN run of subspace dimension ``m``. Returns (curve,
    optimizer)."""
    from krylov_crn_tpu_torch.solvers.sscn import SSCN

    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=m, tolerance=0,
               label=f"SSCN (m={m})")
    alg.warm(np.asarray(x0))
    return _run_stored(alg, x0, it_max, t_max, loss.A_host, b), alg


def leg_f_best(loss, curves) -> float:
    """The leg's best value from fp64-grade values only: the certified
    exact curves, and the oracle's f_opt where a curve has none (the run
    then pinned its exact values there) or the run is fp64. The JAX tool
    always folds f_opt in. An fp32 value reading is a two-float sum of
    fp32 terms and carries the terms' evaluation error, which does not
    average out: on an H100 the terms of w8a-like (``logsigmoid`` of fp32
    margins) average 3.8e-9 off the fp64 optimum 0.596, a sixteenth of an
    fp32 ulp, and a reading that low or high would shift every certified
    gap by that much (``chip_smoke.py`` prints the offset and its
    parts)."""
    exact = [min(c["exact_fs"]) for c in curves.values() if c.get("exact_fs")]
    if len(exact) < len(curves) or loss.dtype == np.float64:
        exact.append(float(loss.f_opt))
    return min(exact)


def run_ours(A, b, x0, it_max, sscn_dims, dtype, device=None,
             on_curve=None):
    """The port's solvers over the whole grid of one dataset, on
    ``device`` (default: the card). Returns (curves, f_best).
    ``on_curve(curves, f_best)`` is called after each algorithm with the
    curves so far, so that a leg cut short keeps what it finished."""
    n, dim = A.shape
    gram = use_gram(n, dim)
    loss = make_loss(A, b, dtype, device)
    curves = {}

    def done():
        if on_curve is not None:
            on_curve(curves, leg_f_best(loss, curves))

    curves["CRN"], crn = run_crn(loss, b, x0, it_max, gram)
    done()
    curves["Krylov CRN (m=10)"], kry = run_krylov(
        loss, b, x0, it_max, gram, m=10, gram_data=getattr(crn, "gd", None))
    done()
    # the 5x-budget benchmark run (not warmed, as in the JAX tool)
    curves["Benchmark Krylov CRN (m=20)"], _ = run_krylov(
        loss, b, x0, 5 * it_max, gram, m=20,
        gram_data=getattr(kry, "gd", None), label="bench", warm=False,
        t_max=5 * REF_T_MAX)
    done()
    for m in sscn_dims:
        curves[f"SSCN (m={m})"], _ = run_sscn(loss, b, x0, it_max, m)
        done()
    return curves, leg_f_best(loss, curves)


def merge_json(path, dataset, leg, curves, f_best, meta):
    data = {}
    if os.path.isfile(path):
        with open(path) as fh:
            data = json.load(fh)
    data.setdefault("dataset", dataset)
    data.update(meta)
    legs = data.setdefault("legs", {})
    legs[leg] = {"curves": curves, "f_best": f_best,
                 "recorded": time.strftime("%Y-%m-%d %H:%M:%S")}
    data["f_star"] = min(v["f_best"] for v in legs.values())

    # final gaps per leg/alg against the shared f*: fp64-grade values
    # only (exact values for fused fp32 runs, the already-fp64 trace
    # otherwise). fp64_verified marks which is which; a negative gap
    # would mean an inconsistent f* and is surfaced, not clamped.
    def final_gap(c):
        fs = c.get("exact_fs") or c["fs"]
        return (min(fs) - data["f_star"]) if fs else None

    data["final_gaps"] = {
        lg: {alg: final_gap(c) for alg, c in v["curves"].items()}
        for lg, v in legs.items()}
    data["fp64_verified"] = {
        lg: {alg: bool(c.get("exact_fs")) or lg in ("reference", "cpu-fp64")
             for alg, c in v["curves"].items()}
        for lg, v in legs.items()}
    neg = [(lg, alg, g) for lg, gaps in data["final_gaps"].items()
           for alg, g in gaps.items() if g is not None and g < -1e-12]
    if neg:
        print(f"[figure2] WARNING: negative final gaps {neg} — "
              "f* inconsistent across legs")
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)
    return data


def plot(path_json, out_pdf, time_axis=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(path_json) as fh:
        data = json.load(fh)
    f_star = data["f_star"]
    plt.figure(figsize=(6.4, 4.8))
    styles = {"h100-fp32": "-", "cpu-fp64": ":"}
    markers = {"CRN": "o", "Krylov CRN (m=10)": "v"}
    for leg, v in data["legs"].items():
        for alg, c in v["curves"].items():
            if alg.startswith("Benchmark"):
                continue
            # exact host-verified points when the leg recorded them
            if c.get("exact_fs"):
                xs = c["exact_ts"] if time_axis else c["exact_its"]
                fs = c["exact_fs"]
            else:
                xs = c["ts"] if time_axis else c["its"]
                fs = c["fs"]
            gaps = np.maximum(np.asarray(fs) - f_star, 1e-16)
            plt.plot(xs, gaps, styles.get(leg, "-"),
                     marker=markers.get(alg, "^"), markersize=4,
                     markevery=max(1, len(gaps) // 20),
                     label=f"{alg} [{leg}]")
    plt.yscale("log")
    plt.xlabel("Time (s)" if time_axis else "Iteration")
    plt.ylabel(r"$f(x)-f^*$")
    plt.title("{} (n={:,}, d={:,})".format(
        data["dataset"], data.get("n", 0), data.get("d", 0)))
    plt.legend(fontsize=7)
    plt.grid(alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_pdf)
    plt.close()


def leg_meta(name, A, it_max, leg, device):
    """Provenance of one leg's run: the problem, and for a card leg the
    card's name and power limit."""
    from krylov_crn_tpu_torch.data.synthetic import synthetic_meta

    meta = {"n": A.shape[0], "d": A.shape[1], "nnz": int(A.nnz),
            "it_max": it_max, "problem": synthetic_meta(name)}
    if device != "cpu":
        from krylov_crn_tpu_torch.utils.profiling import card_description

        meta[f"device_{leg}"] = card_description()
    return meta


def run_dataset(name, leg="h100-fp32", it_max=None, out=OUT_DIR):
    """Run one dataset's grid for one leg and merge it into
    ``out/name.json``; returns the merged data."""
    grid_it, sscn_dims = GRID[name]
    it_max = it_max or grid_it
    dtype, device = LEGS[leg]
    os.makedirs(out, exist_ok=True)
    A, b, x0 = build_problem(name)
    meta = leg_meta(name, A, it_max, leg, device)
    path = os.path.join(out, f"{name}.json")
    t0 = time.perf_counter()

    def save(curves, f_best):
        merge_json(path, name, leg, curves, f_best, meta)
        print(f"[{name}] {leg} leg: {list(curves)[-1]} done, "
              f"{time.perf_counter() - t0:.0f}s")

    curves, f_best = run_ours(A, b, x0, it_max, sscn_dims, dtype, device,
                              on_curve=save)
    print(f"[{name}] {leg} leg: {time.perf_counter() - t0:.0f}s")
    return merge_json(path, name, leg, curves, f_best, meta)


def plot_dataset(name, out=OUT_DIR):
    jpath = os.path.join(out, f"{name}.json")
    plot(jpath, os.path.join(out, f"iteration_{name}.pdf"))
    plot(jpath, os.path.join(out, f"time_{name}.pdf"), time_axis=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="all",
                   choices=["all", *GRID.keys()])
    p.add_argument("--leg", default="h100-fp32", choices=list(LEGS))
    p.add_argument("--it_max", type=int, default=None)
    p.add_argument("--out", default=OUT_DIR)
    args = p.parse_args(argv)

    names = list(GRID) if args.dataset == "all" else [args.dataset]
    for name in names:
        data = run_dataset(name, args.leg, args.it_max, args.out)
        try:
            plot_dataset(name, args.out)
        except ImportError as e:
            print(f"[{name}] figures skipped ({e}); draw them from the "
                  f"JSON with plot_dataset where matplotlib is installed")
        print(f"[{name}] f* = {data['f_star']:.12g}")
        for leg, gaps in data["final_gaps"].items():
            print(f"  {leg}: " + ", ".join(
                f"{a}={g:.3g}" for a, g in gaps.items() if g is not None))


if __name__ == "__main__":
    main()
