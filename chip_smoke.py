#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Phases (each raises on failure, so the exit code is non-zero):

1. device   require CUDA; print the card's name and power limit;
2. build    compile csrc/symv.cu and csrc/matvec.cu with nvcc, one process
            each, started together (into krylov_crn_tpu_torch/_build);
3. kernel   SYMV kernel against its plain PyTorch version and an fp64
            product on bitwise-symmetric random K (one tile, an odd tile
            count, n_pad = 20480): relative error below 1e-6, bitwise
            reproducible;
4. main     the rcv1-like stand-in (20242 x 47236, 1.5M nnz, fp32): device
            K build, then GramKrylov(m=10).run_fused(it_max=48, chunk=24,
            certify=True), with f* from an m=20 run of 192 iterations on the
            same K. Requires a certified exact gap <= 1e-8 within 48
            iterations, non-increasing exact chunk-boundary values, and every
            K-matvec on the card launched through the SYMV kernel;
5. kernel@K the kernel against plain and fp64 on the built K, and both
            timed with CUDA events (median of 25 chained calls);
6. small    an n = 4096 problem in fp32 on the card against the port's fp64
            CPU run (held against the JAX package by the CPU tests): the
            certified fp32 optimum is no more than 1e-8 above the fp64 one;
7. matvec   the dense matvec kernel against its plain version and an fp64
            product, fp32 and bf16 K at (20480, 20480), w8a's (49749, 300)
            and (300, 49749), and a ragged (1003, 3333): relative error
            below 1e-6, bitwise reproducible; kernel and plain timed with
            CUDA events (utils/profiling) at n = 20480 and on w8a's copies;
8. dense    the d-space path on the w8a-like stand-in (49749 x 300, fp32 on
            the card, dense branch): CubicKrylov(m=10) for 100 iterations
            and CubicNewton("full") for 20, every iterate's loss
            re-evaluated in fp64 on the host. f* is the port's fp64
            CubicNewton("full") on the CPU, which must agree with the JAX
            package's recorded fp64 optimum within 1e-11. Requires a final
            gap <= 1e-9 for both, a loss trace that never rises by more
            than 1e-12 (fp64 re-evaluation of fp32 iterates that differ by
            rounding), and every dense-branch product on the card launched
            through the matvec kernel;
9. sparse   CubicKrylov(m=10) on the rcv1-like stand-in (CSR branch) for 10
            iterations in fp32 on the card, twice (the two runs must agree
            bitwise), against the port's fp64 CPU run of the same 10
            iterations: the fp64-evaluated loss of the last iterate within
            1e-6 relative;
10. measure the ported tools/measure_matvec.py rows at n = 20480.

Prints a JSON line of kernel records, then a last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GAP = 1e-8
SYMV_TOL = 1e-6
MATVEC_TOL = 1e-6
DSPACE_GAP = 1e-9
RISE_TOL = 1e-12  # fp64 re-evaluation of fp32 iterates
# the JAX package's fp64 optimum of w8a-like (PROBLEM_VERSION 4, seed 0;
# artifacts/figure2/w8a-like.json, f_star) and the bound on agreeing with it
W8A_F_STAR = 0.5962522636038963
F_STAR_TOL = 1e-11
SPARSE_REL_TOL = 1e-6


def _symmetric(n, gen, device):
    import torch

    G = torch.randn((n, n), generator=gen, device=device)
    return (G + G.T) * 0.5  # bitwise symmetric: fp addition commutes


def _rel(y, ref):
    import torch

    return float(torch.linalg.norm(y.double() - ref) / torch.linalg.norm(ref))


def _alternating_ms(kernel, plain, x, reps=25):
    """plain, kernel, kernel, plain on the same card: lists of the median
    ms per call (utils/profiling) of each run."""
    from krylov_crn_tpu_torch.utils.profiling import device_time_per_call

    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if name == "kernel" else plain
        t[name].append(device_time_per_call(fn, x, reps=reps))
    return t["kernel"], t["plain"]


def _f64_loss(A, b01, x):
    """Exact fp64 loss of an iterate on the host (sparse A)."""
    m = A @ np.asarray(x, np.float64)
    ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
    return float(np.mean((1.0 - b01) * m - ls))


def _iterates_f64(A, b, trace):
    b01 = (np.asarray(b) > 0).astype(np.float64)
    return [_f64_loss(A, b01, x.cpu().numpy() if hasattr(x, "cpu") else x)
            for x in trace.iterates()]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from krylov_crn_tpu_torch.ops import _kernels
    from krylov_crn_tpu_torch.ops import matvec as matvec_mod
    from krylov_crn_tpu_torch.ops import symv as symv_mod

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        for f in [pool.submit(symv_mod._library),
                  pool.submit(matvec_mod._library)]:
            f.result()
    s = time.perf_counter() - t0
    nv = {k: round(v, 3) for k, v in _kernels.last_build_seconds.items()}
    print(f"build: symv.cu and matvec.cu in {s:.3f} s (nvcc {nv})")
    return s


def phase_kernel(dev):
    import torch

    from krylov_crn_tpu_torch.ops.symv import BLOCK, symv, symv_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for n in (BLOCK, 13 * BLOCK, 20480):
        K = _symmetric(n, gen, dev)
        x = torch.randn(n, generator=gen, device=dev)
        y = symv(K, x)
        y2 = symv(K, x)
        yp = symv_plain(K, x)
        ref = K.double() @ x.double()
        torch.cuda.synchronize()
        rel, rel_plain = _rel(y, ref), _rel(yp, ref)
        err = float((y - yp).abs().max())
        print(f"kernel n={n}: rel err {rel:.3e} (plain {rel_plain:.3e}), "
              f"max |kernel - plain| {err:.3e}")
        if not rel < SYMV_TOL:
            raise RuntimeError(f"symv rel err {rel:.3e} >= {SYMV_TOL} at n={n}")
        if not torch.equal(y, y2):
            raise RuntimeError(f"symv not bitwise reproducible at n={n}")
        out[n] = dict(rel_err=rel, rel_err_plain=rel_plain,
                      max_abs_err=err)
        del K
    return out


def phase_main(dev):
    import torch

    from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.symv import symv

    t0 = time.perf_counter()
    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    print(f"main: rcv1-like {A.shape} nnz {A.nnz} generated in "
          f"{time.perf_counter() - t0:.2f} s")
    loss = LogisticRegression(A, b, dtype=np.float32)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=dev, label="gram")

    symv.launches = 0
    k_matvec.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg.init_run(x0, 42)
    alg.initialized = True
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = alg.run_fused(x0, it_max=48, chunk=24, certify=True)
    race_s = time.perf_counter() - t0
    race_launches = symv.launches
    t0 = time.perf_counter()
    ref = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=20, tolerance=0,
                     device=dev, label="gram-fstar", gram_data=alg.gd)
    ref.run_fused(x0, it_max=192, chunk=32)
    fstar_s = time.perf_counter() - t0
    launches, calls = symv.launches, k_matvec.cuda_calls

    f_star = float(loss.f_opt)
    its = list(trace.metrics["exact_its"])
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    gaps = [f - f_star for f in fs]
    cross = next((it for it, g in zip(its, gaps) if g <= GAP), None)
    it_to_t = dict(zip(trace.its, trace.ts))
    bfs = list(trace.metrics["boundary_fs"])
    print(f"main: K build {build_s:.3f} s (n_pad {alg.gd.n_padded}), race "
          f"{race_s:.3f} s for {alg.it} iterations, f* run {fstar_s:.3f} s")
    print(f"main: f* {f_star:.17g}; crossing at iteration {cross} "
          f"(t {it_to_t.get(cross, float('nan')):.3f} s into the race); "
          f"final certified gap {gaps[-1]:.3e}, best {min(gaps):.3e}")
    print(f"main: boundary exact values {bfs}; rollbacks "
          f"{trace.metrics['rollback_its']}")
    print(f"main: symv launches {launches} (race {race_launches}), "
          f"k_matvec calls on the card {calls}")
    if not (launches == calls and race_launches > 0):
        raise RuntimeError(f"K-matvecs bypassed the kernel: {launches} "
                           f"launches vs {calls} calls")
    if cross is None or cross > 48:
        raise RuntimeError(f"no certified {GAP} gap within 48 iterations "
                           f"(best {min(gaps):.3e})")
    if any(b2 > b1 for b1, b2 in zip(bfs, bfs[1:])):
        raise RuntimeError(f"exact boundary values increased: {bfs}")
    lv = np.asarray(trace.loss_vals)
    if lv.shape != (alg.it + 1,) or not np.all(np.isfinite(lv)):
        raise RuntimeError(f"bad loss trace: shape {lv.shape}")
    return alg, dict(build_s=build_s, race_s=race_s, fstar_s=fstar_s,
                     iterations=alg.it, crossing_it=cross,
                     crossing_t=it_to_t.get(cross), f_star=f_star,
                     final_gap=gaps[-1], best_gap=min(gaps),
                     exact_fs=fs, boundary_fs=bfs, launches=launches,
                     race_launches=race_launches, kmatvec_calls=calls)


def phase_kernel_on_K(dev, K):
    import torch

    from krylov_crn_tpu_torch.ops.symv import symv, symv_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(K.shape[0], generator=gen, device=dev)
    y, yp = symv(K, x), symv_plain(K, x)
    ref = K.double() @ x.double()
    rel, rel_plain = _rel(y, ref), _rel(yp, ref)
    err = float((y - yp).abs().max())
    if not rel < SYMV_TOL:
        raise RuntimeError(f"symv rel err {rel:.3e} on the built K")
    kms, pms = _alternating_ms(lambda v: symv(K, v),
                               lambda v: symv_plain(K, v), x)
    ms, plain_ms = min(kms), min(pms)
    n = K.shape[0]
    print(f"kernel@K n={n}: rel err {rel:.3e} (plain {rel_plain:.3e}), max "
          f"|kernel - plain| {err:.3e}; kernel {kms} ms, torch.mv "
          f"{pms} ms; kernel reads {n * (n + 64) * 2 / 1e6:.0f} MB "
          f"-> {n * (n + 64) * 2 / (ms * 1e-3) / 1e9:.0f} GB/s")
    return dict(rel_err=rel, rel_err_plain=rel_plain, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, ms_runs=kms, plain_ms_runs=pms)


def phase_small(dev):
    """fp32 on the card against fp64 on the CPU, on the n = 4096 topic
    problem with an interior optimum that the JAX package's
    test_fp32_production_path_at_scale_fast_tail uses, with its bound."""
    from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg((4096, 8192, 131072), seed=2, profile="topic",
                            topic_params=dict(R=24, n_clusters=8,
                                              own_frac=0.45, pop_exp=1.1))
    x0 = np.ones(A.shape[1]) * 0.5
    f = {}
    for dtype, device in ((np.float64, "cpu"), (np.float32, dev)):
        loss = LogisticRegression(A, b, dtype=dtype)
        alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                         tolerance=0, device=device)
        tr = alg.run_fused(x0, it_max=64, chunk=16)
        f[np.dtype(dtype).name] = float(
            min(tr.metrics.get("exact_fs", tr.loss_vals)))
    diff = f["float32"] - f["float64"]
    print(f"small: fp32 on the card {f['float32']:.17g}, fp64 on the CPU "
          f"{f['float64']:.17g}, difference {diff:.3e}")
    if not diff < GAP:
        raise RuntimeError(f"card fp32 optimum above the fp64 one by "
                           f"{diff:.3e}")
    return dict(f32_card=f["float32"], f64_cpu=f["float64"], diff=diff)


def phase_matvec(dev):
    """The dense matvec kernel against plain and fp64 at the d-space and
    tool shapes; timed at n = 20480 and on w8a's padded copies."""
    import torch

    from krylov_crn_tpu_torch.data.formats import padded_dense
    from krylov_crn_tpu_torch.ops.matvec import (
        matvec,
        matvec_plain,
        split_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"cases": {}, "max_abs_err": 0.0}
    for n, m in ((20480, 20480), (49749, 300), (300, 49749), (1003, 3333)):
        K32 = torch.randn((n, m), generator=gen, device=dev)
        x = torch.randn(m, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            K = K32.to(dtype)
            plan = split_plan(n, m, K.element_size())
            y, y2, yp = matvec(K, x), matvec(K, x), matvec_plain(K, x)
            ref = K.double() @ x.double()
            torch.cuda.synchronize()
            rel, rel_plain = _rel(y, ref), _rel(yp, ref)
            err = float((y - yp).abs().max())
            key = f"{n}x{m}_{str(dtype).removeprefix('torch.')}"
            print(f"matvec {key}: splits {plan[0]}, rel err {rel:.3e} (plain "
                  f"{rel_plain:.3e}), max |kernel - plain| {err:.3e}")
            if not rel < MATVEC_TOL:
                raise RuntimeError(f"matvec rel err {rel:.3e} at {key}")
            if not torch.equal(y, y2):
                raise RuntimeError(f"matvec not bitwise reproducible at {key}")
            out["cases"][key] = dict(splits=plan[0], rel_err=rel,
                                     rel_err_plain=rel_plain, max_abs_err=err)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if n == 20480:
                kms, pms = _alternating_ms(lambda v: matvec(K, v),
                                           lambda v: matvec_plain(K, v), x)
                out[f"ms_{key}"], out[f"plain_ms_{key}"] = kms, pms
                print(f"matvec {key}: kernel {kms} ms, plain {pms} ms")
            del K
        del K32
    # the solver's operands: w8a-like's padded dense copies of A and A^T
    Ad = torch.randn((49749, 300), generator=gen, device=dev)
    for name, M in (("w8a_A", Ad), ("w8a_At", Ad.T)):
        K = padded_dense(M, dev)
        x = torch.randn(K.shape[1], generator=gen, device=dev)
        kms, pms = _alternating_ms(lambda v: matvec(K, v),
                                   lambda v: matvec_plain(K, v), x)
        out[f"ms_{name}"], out[f"plain_ms_{name}"] = kms, pms
        print(f"matvec {name} {tuple(K.shape)} fp32 (ld {K.stride(0)}): "
              f"kernel {kms} ms, plain {pms} ms")
    torch.cuda.empty_cache()
    return out


def _dspace_run(cls, loss, x0, it_max, **kw):
    alg = cls(loss=loss, reg_coef=1e-3, tolerance=0, **kw)
    t0 = time.perf_counter()
    tr = alg.run(x0, it_max=it_max)
    return alg, tr, time.perf_counter() - t0


def phase_dense(dev):
    """The d-space path on w8a-like, dense branch, fp32 on the card."""
    import torch

    from krylov_crn_tpu_torch import CubicKrylov, CubicNewton
    from krylov_crn_tpu_torch import LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.ops.spmv import dense_matvec
    from krylov_crn_tpu_torch.ops.symv import symv

    A, b = synthetic_logreg("w8a-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    t0 = time.perf_counter()
    _, tr64, _ = _dspace_run(CubicNewton, LogisticRegression(
        A, b, dtype=np.float64), x0, 20, cubic_solver="full")
    f_star = min(_iterates_f64(A, b, tr64))
    print(f"dense: w8a-like {A.shape} nnz {A.nnz}; fp64 CPU CRN f* "
          f"{f_star:.17g} in {time.perf_counter() - t0:.2f} s (JAX package "
          f"{W8A_F_STAR:.17g}, difference {f_star - W8A_F_STAR:.3e})")
    if not abs(f_star - W8A_F_STAR) < F_STAR_TOL:
        raise RuntimeError(f"fp64 f* {f_star!r} disagrees with the JAX "
                           f"package's {W8A_F_STAR!r}")

    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    loss.data  # the device format is set-up, not part of the runs
    torch.cuda.synchronize()
    matvec.launches = symv.launches = dense_matvec.cuda_calls = 0
    out = {"f_star": f_star}
    for label, cls, its, kw in (
            ("krylov", CubicKrylov, 100, dict(subspace_dim=10)),
            ("crn", CubicNewton, 20, dict(cubic_solver="full"))):
        alg, tr, secs = _dspace_run(cls, loss, x0, its, **kw)
        fs = _iterates_f64(A, b, tr)
        gaps = [f - f_star for f in fs]
        rise = max(np.diff(fs))
        print(f"dense {label}: {alg.it} iterations in {secs:.3f} s, final "
              f"gap {gaps[-1]:.3e} (best {min(gaps):.3e}), largest rise "
              f"{rise:.3e}, solver_it {int(alg.state.solver_it)}")
        if not (len(fs) == its + 1 and np.all(np.isfinite(fs))):
            raise RuntimeError(f"{label}: bad loss trace ({len(fs)} values)")
        if not gaps[-1] <= DSPACE_GAP:
            raise RuntimeError(f"{label}: final gap {gaps[-1]:.3e} above "
                               f"{DSPACE_GAP}")
        if not rise <= RISE_TOL:
            raise RuntimeError(f"{label}: the loss rose by {rise:.3e}")
        out[label] = dict(iterations=alg.it, seconds=secs, final_gap=gaps[-1],
                          best_gap=min(gaps), largest_rise=rise,
                          exact_fs=fs)
    launches, calls = matvec.launches, dense_matvec.cuda_calls
    print(f"dense: matvec launches {launches}, dense-branch products on the "
          f"card {calls}, symv launches {symv.launches}")
    if not (launches == calls and launches > 0):
        raise RuntimeError(f"dense products bypassed the kernel: {launches} "
                           f"launches vs {calls} calls")
    out.update(launches=launches, dense_calls=calls)
    return out


def phase_sparse(dev):
    """CubicKrylov on rcv1-like through the CSR branch: fp32 on the card
    (twice) against fp64 on the CPU, 10 iterations."""
    import torch

    from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.spmv import dense_matvec

    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    dense_matvec.cuda_calls = 0
    runs = {}
    for key, dtype, device in (("f64_cpu", np.float64, "cpu"),
                               ("f32_card", np.float32, dev),
                               ("f32_card_again", np.float32, dev)):
        loss = LogisticRegression(A, b, dtype=dtype, device=device)
        if loss.data.dense is not None:
            raise RuntimeError("rcv1-like must take the CSR branch")
        alg, tr, secs = _dspace_run(CubicKrylov, loss, x0, 10,
                                    subspace_dim=10)
        runs[key] = dict(x=alg.state.x, seconds=secs,
                         f=_iterates_f64(A, b, tr)[-1])
        print(f"sparse {key}: 10 iterations in {secs:.3f} s, fp64 loss of "
              f"the last iterate {runs[key]['f']:.17g}")
    same = torch.equal(runs["f32_card"]["x"], runs["f32_card_again"]["x"])
    f64, f32 = runs["f64_cpu"]["f"], runs["f32_card"]["f"]
    rel = abs(f32 - f64) / abs(f64)
    # cuSPARSE's CSR product (not used by the port), for the record
    Ad = LogisticRegression(A, b, dtype=np.float32, device=dev).data.a
    v = torch.rand(A.shape[1], device=dev)
    ys = [Ad @ v for _ in range(20)]
    cusparse_same = all(torch.equal(ys[0], y) for y in ys)
    print(f"sparse: fp32 card vs fp64 CPU, relative {rel:.3e}; two card runs "
          f"bitwise equal: {same}; dense products {dense_matvec.cuda_calls}; "
          f"cuSPARSE CSR @ bitwise equal over 20 calls: {cusparse_same}")
    if not same:
        raise RuntimeError("two fp32 card runs of the CSR path differ")
    if dense_matvec.cuda_calls:
        raise RuntimeError("the CSR path ran dense products")
    if not rel <= SPARSE_REL_TOL:
        raise RuntimeError(f"sparse: fp32 card loss {f32!r} vs fp64 CPU "
                           f"{f64!r}: relative {rel:.3e}")
    return dict(f64_cpu=f64, f32_card=f32, rel=rel, runs_equal=same,
                cusparse_repeatable=cusparse_same,
                seconds={k: r["seconds"] for k, r in runs.items()})


def phase_measure():
    from krylov_crn_tpu_torch.tools.measure_matvec import measure

    rows = measure(20480)
    for r in rows:
        print(f"measure n=20480 {r['name']:12s} {r['ms']:8.4f} ms "
              f"{r['gbps']:7.1f} GB/s roofline {r['roofline']:6.1%}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record to this JSON")
    args = ap.parse_args(argv)

    import torch

    card = phase_device()
    dev = torch.device("cuda", 0)
    record = {"card": card, "build_s": phase_build(),
              "kernel": phase_kernel(dev)}
    alg, record["main"] = phase_main(dev)
    record["kernel_on_K"] = phase_kernel_on_K(dev, alg.gd.K)
    del alg
    torch.cuda.empty_cache()
    record["small"] = phase_small(dev)
    record["matvec"] = phase_matvec(dev)
    record["dense"] = phase_dense(dev)
    record["sparse"] = phase_sparse(dev)
    record["measure"] = phase_measure()
    kk, mv = record["kernel_on_K"], record["matvec"]
    kernels = {"kernels": [{
        "name": "symv_upper", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/symv.cu",
        "replaces": "krylov_crn_tpu/ops/symv.py:69",
        "launches": record["main"]["launches"],
        "max_abs_err": kk["max_abs_err"], "ms": kk["ms"],
        "plain_ms": kk["plain_ms"]}, {
        "name": "matvec", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/matvec.cu",
        "replaces": "tools/measure_matvec.py:35",
        "launches": record["dense"]["launches"],
        "max_abs_err": mv["max_abs_err"],
        "ms": min(mv["ms_20480x20480_float32"]),
        "plain_ms": min(mv["plain_ms_20480x20480_float32"])}]}
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(record, **kernels), fh, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
