"""Time to a certified 1e-8 gap on one NVIDIA card: the port of ``bench.py``.

    python -m krylov_crn_tpu_torch.bench [--reps N]

The headline metric is ``bench.py``'s: **wall-clock to a 1e-8
suboptimality gap** on the news20-like stand-in (19,996 x 1,355,191), K
build included, for the fp32 Gram-space Krylov-CRN solver (m=10), against
a shared empirical f* (the min over every certified value either side
observed, the reference's own protocol). The same race runs on the
rcv1-like stand-in. Every K-matvec of both races and of both f* runs goes
through the hand-written SYMV kernel (``csrc/symv.cu``): each race counts
the kernel's launches and the K-matvecs on the card and raises if they
differ.

Also reported, as in ``bench.py``: the bandwidth of a plain fp32
K-matvec (``torch.mv``) and its share of the device-memory roofline, the
SYMV kernel's time and effective bandwidth, and the sparse HVP's
throughput in nnz/s.

Timing: every host-clock region ends in ``torch.cuda.synchronize()``;
kernel times are CUDA-event medians of chained calls
(``utils/profiling.device_time_per_call``). One-time costs stay out of
the timed regions, as in ``bench.py``: before a race's first attempt the
kernel libraries are loaded (their nvcc build at first use) and SYMV and
one cuBLAS product run once on a small K, which also makes the CUDA
context and the cuBLAS handle; after each attempt's K build,
``GramKrylov.warm_fused`` captures the race's step graphs, as
``bench.py`` calls the JAX package's ``warm_fused`` before its timed race.
Nothing else is warmed. Each side runs
``reps`` end-to-end attempts and scores its min time-to-gap; every
attempt's time rides in the JSON.

The upstream reference (``bench_reference``) is looked for in a
``reference/`` directory at the repository's root; without it that leg
returns None and ``vs_baseline`` is null.

Prints ONE JSON line with ``bench.py``'s keys, plus ``card`` (the card's
name and power limit), ``hvp_format`` and, per race, ``ours_crossing_it``,
``symv_launches``, ``graph_replays`` and ``k_build``. Needs a card:
without one it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from krylov_crn_tpu_torch.config import resolve_device
from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg, synthetic_meta

__all__ = ["M", "GAP", "CHUNK", "OUR_IT_MAX", "FSTAR_IT", "REF_IT_MAX",
           "REF_T_MAX", "Attempt", "bench_ours", "bench_reference", "race",
           "kmatvec_roofline", "coo_hvp_nnz_per_s", "main"]

M = 10
GAP = 1e-8
# iterations per chunk between host syncs, also the exact fp64 correction
# cadence: the crossing lands a few iterations after the first chunk
# boundary's exact correction, so the certified crossing (35 on rcv1-like,
# 25 on news20-like on the card) needs the second chunk
CHUNK = 24
# 48 = exactly two chunks
OUR_IT_MAX = 48
FSTAR_IT = 192  # m=20 benchmark run for the empirical f*
REF_IT_MAX = 50  # reference crosses at it ~28-32 (cubic_newton.sh uses 50)
REF_T_MAX = 300.0

REFERENCE_DIR = Path(__file__).resolve().parent.parent / "reference"


class Attempt(NamedTuple):
    """One end-to-end attempt of ours: ``bench.py``'s (build_s, ts, fs,
    f_best), then the certified iterations ``its`` that ``ts``/``fs``
    belong to and the attempt's synchronized race seconds ``race_s``."""

    build_s: float
    ts: list
    fs: list
    f_best: float
    its: tuple
    race_s: float


def _problem(name):
    A, b = synthetic_logreg(name, seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    return A, b, x0


def _crossing(ts, gaps, target):
    """First wall-clock time at which the gap is <= target (None if never)."""
    for t, g in zip(ts, gaps):
        if g <= target:
            return float(t)
    return None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load_kernels(dev):
    """The one-time costs, before a race's first attempt: the SYMV
    library (built by nvcc at first use, ``ops/_kernels.py``), the CUDA
    context and the cuBLAS handle. Nothing the race computes is warmed."""
    if dev.type != "cuda":
        return
    from krylov_crn_tpu_torch.ops.symv import BLOCK, symv

    K = torch.zeros((BLOCK, BLOCK), device=dev)
    x = torch.zeros(BLOCK, device=dev)
    symv(K, x)
    torch.mv(K, x)
    torch.cuda.synchronize(dev)


def bench_ours(A, b, x0, device=None):
    """fp32 Gram Krylov-CRN (m=10) on the card.

    Returns an ``Attempt``: ``bench.py``'s (build_s, ts, fs, f_best) with
    ts/fs the race's wall-times and **exact fp64 host-verified** loss
    values at every certified iterate (``metrics["exact_its"/"exact_fs"]``);
    the crossing detection must not read the ~1e-6-noise within-chunk
    device values. ts is host time from the start of ``run_fused``, each
    chunk's reading taken after the chunk's values reached the host, so it
    includes the device's completion. f_best is ``loss.f_opt`` after the
    timed run and an m=20 ``FSTAR_IT``-iteration run on the same K, the
    reference's f* protocol: an exact fp64 running best."""
    from krylov_crn_tpu_torch.models.logistic import LogisticRegression
    from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylov

    dev = resolve_device(device)
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev,
                              want_dense=False)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=M, tolerance=0,
                     label="gram", device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    alg.init_run(x0, 42)  # the device K build
    alg.initialized = True
    _sync(dev)
    build_s = time.perf_counter() - t0
    # SYMV reads the upper triangle only: a K that is not bitwise
    # symmetric would race on another matrix (checked outside the timing)
    if not torch.equal(alg.gd.K, alg.gd.K.T):
        raise RuntimeError("bench: the built K is not bitwise symmetric")
    # capture the race's step graphs outside its timed region
    alg.warm_fused(chunk=CHUNK, certify=True)

    # certify=True: every within-chunk iterate is exact-evaluated on the
    # host after the run, so the crossing is certified at its
    # per-iteration interpolated timestamp
    t0 = time.perf_counter()
    trace = alg.run_fused(x0, it_max=OUR_IT_MAX, chunk=CHUNK, certify=True)
    _sync(dev)
    race_s = time.perf_counter() - t0
    ex_its = list(trace.metrics["exact_its"])
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    it_to_t = dict(zip(trace.its, trace.ts))
    ts = [float(it_to_t[i]) for i in ex_its]

    # empirical f*: higher-budget m=20 run, reusing the built K; its
    # best exact value sharpens the shared f*
    bench_alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=2 * M,
                           tolerance=0, label="gram-bench",
                           gram_data=alg.gd)
    t0 = time.perf_counter()
    bench_alg.run_fused(x0, it_max=FSTAR_IT, chunk=32)
    _sync(dev)
    print(f"bench: m=20 f* run {time.perf_counter() - t0:.3f} s for "
          f"{bench_alg.it} iterations", file=sys.stderr)
    f_best = float(loss.f_opt)
    return Attempt(build_s, ts, fs, f_best, tuple(ex_its), race_s)


def bench_reference(A, b, x0):
    """The reference implementation, in-process, on the host CPU (fp64).

    Returns (ts, fs, f_best) — per-iteration wall times and loss values
    (its Trace stores every iteration at these it_max), and its own
    running-best f — or None when ``reference/`` holds no upstream code."""
    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")
        numba.njit = lambda f=None, **kw: (f if callable(f)
                                           else (lambda g: g))
        sys.modules["numba"] = numba
    ref_dir = str(REFERENCE_DIR)
    sys.path.insert(0, ref_dir)
    try:
        from optimizer.cubic import Cubic_Krylov_LS
        from optimizer.loss import LogisticRegression as RefLogReg
    except ImportError:
        sys.path.remove(ref_dir)
        return None
    ref_loss = RefLogReg(A, b, l1=0, l2=0, store_mat_vec_prod=True)
    alg = Cubic_Krylov_LS(loss=ref_loss, reg_coef=1e-3, subspace_dim=M,
                          tolerance=0, label="ref", tqdm=False)
    alg.run(x0=x0, it_max=REF_IT_MAX, t_max=REF_T_MAX)
    alg.compute_loss_of_iterates()
    sys.path.remove(ref_dir)
    return (list(alg.trace.ts), [float(v) for v in alg.trace.loss_vals],
            float(ref_loss.f_opt))


def race(name, reps=2, device=None):
    """Time-to-1e-8-gap on one dataset; shared f* across implementations.

    ``bench.py``'s scoring: both sides run ``reps`` end-to-end attempts in
    this process (ours: K build + race + f* run; reference: full run).
    Ours scores the min time-to-gap over the attempts that crossed, with
    build_s and the final gap from that same attempt; the reference scores
    only attempts that crossed, else the max of their wall times (each a
    lower bound on its time-to-gap); f* is the min of both sides' bests.

    Adds ``ours_crossing_it`` (the scored attempt's certified crossing
    iteration, a count that compares across hardware), ``symv_launches``
    (the SYMV kernel's launches over all attempts beside the K-matvecs
    made on the card; they must be equal; a replayed step counts what
    its capture launched), ``graph_replays`` (the replayed steps of all
    attempts, races and f* runs) and ``k_build`` (the K builds''
    panels over all attempts beside those whose bf16 split products ran
    on the card, equal for fp32; each built K is bitwise symmetric or the
    attempt raises)."""
    from krylov_crn_tpu_torch.ops.gram import (
        build_K_device,
        k_matvec,
        syrk_split_P,
    )
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.solvers.krylov_gram import gram_krylov_step

    dev = resolve_device(device)
    A, b, x0 = _problem(name)
    _load_kernels(dev)
    symv.launches = k_matvec.cuda_calls = 0
    gram_krylov_step.graph_replays = 0
    build_K_device.panels = syrk_split_P.cuda_calls = 0
    ours_attempts = []
    for _ in range(reps):
        ours_attempts.append(bench_ours(A, b, x0, device=dev))
        gc.collect()  # the attempt's K (n_pad^2 fp32) goes before the next
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    launches, calls = symv.launches, k_matvec.cuda_calls
    if launches != calls:
        raise RuntimeError(f"{name}: {calls} K-matvecs on the card but "
                           f"{launches} SYMV launches")
    ref_attempts = [bench_reference(A, b, x0) for _ in range(reps)]
    ref_attempts = [r for r in ref_attempts if r is not None]
    f_best = min(a.f_best for a in ours_attempts)
    f_star = (f_best if not ref_attempts
              else min(f_best, min(r[2] for r in ref_attempts)))

    def crossing(a):
        """(seconds into the race, iteration) of the certified crossing."""
        gaps = [f - f_star for f in a.fs]
        it = next((i for i, g in zip(a.its, gaps) if g <= GAP), None)
        return _crossing(a.ts, gaps, GAP), it

    crossings = [crossing(a) for a in ours_attempts]
    for i, (a, (c, it)) in enumerate(zip(ours_attempts, crossings)):
        print(f"bench {name} attempt {i}: build {a.build_s:.3f} s, crossing "
              f"at iteration {it}, {c} s into the race; synchronized race "
              f"{a.race_s:.3f} s", file=sys.stderr)
    ours_times = [None if c is None else a.build_s + c
                  for a, (c, _) in zip(ours_attempts, crossings)]
    best = min(range(len(ours_attempts)),
               key=lambda i: (ours_times[i] is None, ours_times[i]))
    best_t = ours_times[best]
    build_s, fs = ours_attempts[best].build_s, ours_attempts[best].fs
    out = {
        "problem": synthetic_meta(name),
        "build_s": round(build_s, 2),
        "f_star": f_star,
        "ours_gap_reached": best_t is not None,
        "ours_s": round(best_t, 3) if best_t is not None else None,
        "ours_attempts_s": [round(t, 3) if t is not None else None
                            for t in ours_times],
        "ours_final_gap": fs and min(fs) - f_star,
        "ours_crossing_it": crossings[best][1],
        "symv_launches": {"launches": launches, "k_matvec_calls": calls},
        "graph_replays": gram_krylov_step.graph_replays,
        "k_build": {"panels": build_K_device.panels,
                    "split_panels": syrk_split_P.cuda_calls},
    }
    if ref_attempts:
        ref_times = []
        for rts, rfs, _ in ref_attempts:
            c = _crossing(rts, [f - f_star for f in rfs], GAP)
            ref_times.append((c is not None,
                              c if c is not None else rts[-1]))
        crossed = [t for did, t in ref_times if did]
        out["ref_gap_reached"] = bool(crossed)
        # score only attempts that actually crossed; if NONE did, the
        # tightest honest statement is the MAX of the attempts' total
        # wall times — each is a lower bound on its time-to-gap
        out["ref_s"] = round(min(crossed) if crossed
                             else max(t for _, t in ref_times), 3)
        out["ref_attempts"] = [
            {"s": round(t, 3), "crossed": did} for did, t in ref_times]
        if out["ours_s"]:
            out["speedup"] = round(out["ref_s"] / out["ours_s"], 2)
    return out


def _card(device):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"timing needs a card, got device {dev}")
    return dev


def kmatvec_roofline(n=20480, device=None):
    """Bandwidth of the plain fp32 K-matvec (``torch.mv``, the counterpart
    of ``bench.py``'s XLA ``K @ v``) and its share of the device-memory
    roofline (``HBM_BYTES_PER_S``), then the SYMV kernel's ms and its
    effective bandwidth, n^2 * 4 bytes over its time: SYMV streams only
    the upper-triangle tiles, about half of K, so the effective rate can
    exceed the roofline. K is random, made on the card from a seed, and
    not symmetric: SYMV reads its upper triangle and is only timed here.
    Returns (GB/s, roofline fraction, SYMV ms, SYMV effective GB/s)."""
    from krylov_crn_tpu_torch.ops.symv import BLOCK, symv
    from krylov_crn_tpu_torch.utils.profiling import (
        device_time_per_call,
        roofline_fraction,
    )

    dev = _card(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    K = torch.randn((n, n), generator=gen, device=dev) / np.sqrt(n)
    w = torch.randn(n, generator=gen, device=dev)

    sec = device_time_per_call(lambda v: torch.mv(K, v), w) * 1e-3
    gbps = (n * n * 4) / sec / 1e9
    out = (round(gbps, 1), round(roofline_fraction(n * n * 4, sec), 3))
    if n % BLOCK:
        return (*out, None, None)

    ssec = device_time_per_call(lambda v: symv(K, v), w) * 1e-3
    eff = (n * n * 4) / ssec / 1e9
    return (*out, round(ssec * 1e3, 3), round(eff, 1))


def coo_hvp_nnz_per_s(name="rcv1-like", device=None):
    """Sparse fused HVP throughput, Mnnz/s (2 SpMVs per HVP): chained
    v <- HVP(w, v) / ||.|| through ``ops/spmv.hvp_sparse``. The port's
    format is CSR, not the JAX package's COO; the key keeps its name."""
    from krylov_crn_tpu_torch.data.formats import build_dual
    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse
    from krylov_crn_tpu_torch.utils.profiling import device_time_per_call

    dev = _card(device)
    A, b, _ = _problem(name)
    data = build_dual(A, dtype=np.float32, device=dev, want_dense=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(data.n, generator=gen, device=dev).abs()
    v0 = torch.ones(data.d, device=dev)
    sec = device_time_per_call(lambda v: hvp_sparse(data, w, v), v0) * 1e-3
    return round(2 * A.nnz / sec / 1e6, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="end-to-end attempts per side and race (default 2)")
    args = ap.parse_args(argv)

    from krylov_crn_tpu_torch.utils.profiling import card_description

    dev = _card(None)
    card = card_description()
    print(card, file=sys.stderr)
    res_news = race("news20-like", reps=args.reps, device=dev)
    res_rcv1 = race("rcv1-like", reps=args.reps, device=dev)
    gbps, frac, symv_ms, symv_eff = kmatvec_roofline(device=dev)
    coo = coo_hvp_nnz_per_s(device=dev)
    out = {
        "metric": "time_to_1e-8_gap_news20",
        "value": res_news["ours_s"],
        "unit": "s",
        "vs_baseline": res_news.get("speedup"),
        "news20": res_news,
        "rcv1": res_rcv1,
        "kmatvec_gbps": gbps,
        "kmatvec_roofline_frac": frac,
        "symv_ms": symv_ms,
        "symv_effective_gbps": symv_eff,
        "coo_hvp_mnnz_per_s": coo,
        "hvp_format": "csr",
        "gap_target": GAP,
        "card": card,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
