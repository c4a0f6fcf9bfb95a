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
5. kernel@K the kernel against plain and fp64 on the built K (they differ
            by less than 1e-6 of the fp64 product's norm), and both timed
            with CUDA events (median of 25 chained calls); repeated on
            phase 14's K (n_pad 20224), the other shape SYMV is driven at;
6. small    an n = 4096 problem in fp32 on the card against the port's fp64
            CPU run (held against the JAX package by the CPU tests): the
            certified fp32 optimum is no more than 1e-8 above the fp64 one;
6a. division division by n on the card as the JAX package divides
            (ops/math.over_n, a product with fl32(1/n)) and truly for the
            d-space value (div_n): the CPU's bits at n = 49,749, where the
            two forms differ; the gradient and the HVP equal their A^T
            products times fl32(1/n) on the CPU, bit for bit;
6b. rollback GramCRN in fp32 on a 300 x 700 problem with l2 = 1e-2, past
            its fp32 floor: at least one trust-but-verify rollback, after
            each one the verified snapshot's gamma and zeta and the raised
            reg bit for bit, exact values that never rise, and every
            K-matvec through the SYMV kernel;
7. matvec   the dense matvec kernel against its plain version and an fp64
            product, fp32 and bf16 K at (20480, 20480), the (5120, 20480)
            row band of phase 18, w8a's (49749, 300) and (300, 49749), and
            a ragged (1003, 3333): relative error below 1e-6, bitwise
            reproducible, with its plan, shared memory and blocks per SM;
            kernel, plain and torch.mv timed with CUDA events
            (utils/profiling, each call with a cold L2) at n = 20480, on
            the band and on w8a's padded copies;
8. dense    the d-space path on the w8a-like stand-in (49749 x 300, fp32 on
            the card, dense branch): CubicKrylov(m=10) for 100 iterations
            and CubicNewton("full") for 20, every iterate's loss
            re-evaluated in fp64 on the host. f* is the port's fp64
            CubicNewton("full") on the CPU, which must agree with the JAX
            package's recorded fp64 optimum within 1e-11. Requires a final
            gap <= 1e-9 for both, a loss trace that never rises by more
            than 1e-12 (fp64 re-evaluation of fp32 iterates that differ by
            rounding), and every dense-branch product on the card launched
            through the matvec kernel. The oracle's best fp32 value
            reading must lie within one fp32 ulp of f*; its offset is
            printed with its parts (iterate, fp32 margins, fp32 terms),
            and scaling and summing the terms may move it by 1e-9 at most;
9. sparse   CubicKrylov(m=10) on the rcv1-like stand-in (CSR branch) for 10
            iterations in fp32 on the card, twice (the two runs must agree
            bitwise), against the port's fp64 CPU run of the same 10
            iterations: the fp64-evaluated loss of the last iterate within
            1e-6 relative;
10. measure the ported tools/measure_matvec.py rows at n = 20480;
11. cli_gram the port's CLI run grid (cli.run_grid) on the rcv1-like stand-in
            at full width, fp32 on the card: GramCRN (tolerance 1e-8), SSCN
            m=500 and GramKrylov run_fused, 12 iterations each. Requires
            GramCRN's certified exact gap (against phase 4's f*) <= 1e-8
            within 12 iterations, exact values that never increase, and
            every K-matvec on the card launched through the SYMV kernel;
            prints GramCRN's seconds, CG iterations, host reads and
            rollbacks per iteration, and SSCN's gap beside the JAX
            package's m=500 curve (printed, not gated: other coordinates);
12. sscn    SSCN m=500 on rcv1-like (CSR data, column panels) for 20
            iterations: fp32 on the card twice and fp64 on the CPU, one
            generator seed. The card runs must agree bitwise, and the fp64
            loss of the last card iterate must be within 1e-6 relative of
            the CPU run's;
13. cli_dense cli.run_grid on the w8a-like stand-in (d-space path): CRN
            "full", SSCN m=10 and CubicKrylov, 20 iterations. Requires every
            dense-branch product on the card launched through the matvec
            kernel and CRN's final fp64 gap <= 1e-9 against the JAX
            package's optimum;
14. news20  phase 4's protocol and gates on the news20-like stand-in
            (19,996 x 1,355,191, 8.7M nnz, 22 build panels): generation,
            build and race seconds, crossing iteration, final gap, chunks,
            rollbacks and launches are printed;
15. figure2 the Figure-2 tool's functions (tools/run_figure2.py) on the
            card: w8a-like whole (grid (100, [10]): CRN "full", Krylov m=10,
            the 5x-budget m=20 run, SSCN m=10) and news20-like without
            GramCRN (GramKrylov m=10 for 50 certified iterations on phase
            14's K, SSCN m=1000 for 50), each merged with nothing. Requires
            an f_star in each JSON, every certified final gap finite and
            >= -1e-12, w8a-like's Krylov and CRN final gaps <= 1e-9, its
            best fp32 value reading within one fp32 ulp of f*, and the
            products through their kernels;
16. skew    the K build under heavy column skew: the power-law problem at
            rcv1's shape (957,861 nnz, 22 panels, the first holding 722,633;
            skewed by the JAX package's rule nblk * cap > 4 * nnz). K
            against host A A^T on 4,096 sampled rows (rel <= 1e-5), bitwise
            symmetric, and one SYMV on it against fp64 and against its
            plain version;
17. stress1m the sparse HVP of tools/measure_large_n.py (CSR products; no
            hand-written kernel on this path): at 100,000 x 100,000 with 10M
            entries against an fp64 scipy HVP of the arrays copied back (rel
            <= 1e-5); at 1M x 1M with 100M entries two card HVPs bitwise
            equal, finite, and u^T (A^T (w * A v)) = (A u)^T (w * A v) within
            1e-4 relative; prints the tool's JSON row and the bound;
18. mesh    the multi-device layer (krylov_crn_tpu_torch/parallel) in four
            ranks that share this card over gloo (NCCL refuses two ranks on
            one device), started through parallel.launch. Four contexts
            time-slice the card, so every time printed here is a
            correctness run's, not a scaling figure.
            (a) graft_entry.dryrun_multidevice(4, "cuda:0");
            (b) the rcv1-like Gram race at full width on a row-banded K
            (fp32, m=10, chunk 24, it_max 48, certify): a certified 1e-8
            crossing against phase 4's f*, boundary values non-increasing,
            exact values within 1e-5 relative of phase 4's single-device
            race and at the same iterations (past 1e-5, which rounding
            order alone decides, a certified final gap within 1e-8
            instead: ROADMAP C.4); m + 1 all-gathers per step
            (budget m + 2) and no all-reduce; every band product went
            through the matvec kernel (launches == band calls == all-gathers
            on every rank); each rank's band kernel against its plain
            version (K_band @ q) and an fp64 product;
            (c) the rcv1-like d-space CSR path row-sharded: CubicKrylov m=10
            x 10 and SSCN m=500 x 20 against phases 9 and 12's single-card
            results (fp64 loss of the last iterate within 1e-5 relative),
            one all-reduce per HVP (11 per Krylov step, 2 per SSCN step);
            (d) the stress-10m HVP (tools/stress10m_dryrun: 10M x 10M, 100M
            entries, each rank's rows made on the card): one all-reduce,
            within 1e-5 of the single-device HVP of the same entries, beside
            its byte bound;
            (e) prints whether NCCL is available and, if so, runs one
            all-reduce and one all-gather through the mesh on a one-rank
            NCCL group.

The kernel records count the launches of every phase that drives a
solver (each phase resets the counts just before and reads them just
after). The matvec kernel has a record for each shape a path launches it
at, its launches there beside its times at that shape: w8a-like's A
(49749, 300) and A^T (300, 49749) on the d-space paths (counted by shape,
matvec.shape_launches), and the mesh path's band (5120, 20480). Prints
the whole run's seconds, a JSON line of kernel records, then a last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

GAP = 1e-8
SYMV_TOL = 1e-6
MATVEC_TOL = 1e-6
DSPACE_GAP = 1e-9
# the terms' division by n (one rounding each) and their two-float sum
READING_SUM_TOL = 1e-9
RISE_TOL = 1e-12  # fp64 re-evaluation of fp32 iterates
# the JAX package's fp64 optimum of w8a-like (PROBLEM_VERSION 4, seed 0;
# artifacts/figure2/w8a-like.json, f_star) and the bound on agreeing with it
W8A_F_STAR = 0.5962522636038963
F_STAR_TOL = 1e-11
SPARSE_REL_TOL = 1e-6
# GramCRN's certified crossing is at iteration 12; iterations 13-14, where
# fp32 CG runs to its cap, took 196-241 s and made way for phase 18
CLI_GRAM_ITS = 12
MESH_RANKS = 4
MESH_REL_TOL = 1e-5  # fp32 runs in two summation orders, exact fp64 values
SSCN_ITS = 20
SKEW_K_TOL = 1e-5  # fp32-class error of the panel GEMMs
STRESS_REL_TOL = 1e-5  # fp32 segment sums of ~100 products against fp64
STRESS_ADJ_TOL = 1e-4  # fp32 products, both sides summed in fp64


def _symmetric(n, gen, device):
    import torch

    G = torch.randn((n, n), generator=gen, device=device)
    return (G + G.T) * 0.5  # bitwise symmetric: fp addition commutes


def _rel(y, ref):
    import torch

    return float(torch.linalg.norm(y.double() - ref) / torch.linalg.norm(ref))


def _hold_to_plain(tag, y, yp, ref):
    """max |kernel - plain|; raises unless the kernel's result y and the
    plain version's yp differ by less than SYMV_TOL of |ref| (the fp64
    product) in the 2-norm."""
    import torch

    d = y.double() - yp.double()
    rel = float(torch.linalg.norm(d) / torch.linalg.norm(ref))
    if not rel < SYMV_TOL:
        raise RuntimeError(f"{tag}: symv differs from its plain version by "
                           f"{rel:.3e} relative (limit {SYMV_TOL})")
    return float(d.abs().max())


# NVIDIA H100 SXM: 67 TFLOP/s in fp32 outside the tensor cores (the
# published peak at the full 700 W limit; the memory rate, 3.35 TB/s, is
# utils/profiling.HBM_BYTES_PER_S)
PEAK_FP32_FLOPS = 67e12


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of bytes over the memory rate and operations over the peak."""
    from krylov_crn_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _matvec_bound(n, m, itemsize):
    """y = K x for K (n, m): K and x read once, y written once; one
    multiply and one add per entry."""
    return _bound(n * m * itemsize + 4 * (n + m), 2 * n * m)


def _f64_loss_of_margins(b01, m):
    ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
    return float(np.mean((1.0 - b01) * m - ls))


def _f64_loss(A, b01, x):
    """Exact fp64 loss of an iterate on the host (sparse A)."""
    return _f64_loss_of_margins(b01, A @ np.asarray(x, np.float64))


def _reading_offset(tag, reading, f_star):
    """An fp32 value reading minus the fp64 optimum, in fp32 ulps of the
    optimum; raises beyond one ulp. The readings are two-float sums of
    fp32 terms, so they are no fp32 roundings of the optimum: they carry
    the terms' evaluation error, a fraction of an ulp, which is why the
    Figure-2 tool's f* takes certified fp64 values only."""
    ulp = float(np.spacing(np.float32(f_star)))
    off = reading - f_star
    print(f"{tag}: best fp32 value reading {reading:.17g} lies {off:.3e} "
          f"from the fp64 optimum, {off / ulp:+.3f} fp32 ulp (the optimum "
          f"rounded to fp32 would lie {float(np.float32(f_star)) - f_star:.3e})")
    if not abs(off) <= ulp:
        raise RuntimeError(f"{tag}: fp32 value reading off by {off:.3e}, "
                           f"more than one fp32 ulp ({ulp:.3e})")
    return off


def _reading_parts(loss, A, b, f_star):
    """Where an fp32 reading's offset comes from, at the oracle's x_opt
    on the card: the iterate, the fp32 margins, the fp32 terms, their
    two-float sum."""
    from krylov_crn_tpu_torch.models.logistic import (
        logreg_value_from_margins,
        logsig,
    )

    b01 = (np.asarray(b) > 0).astype(np.float64)
    x = loss.x_opt
    Ax = loss.mat_vec_product(x)
    terms = (1.0 - loss.b_t) * Ax - logsig(Ax)
    hi, lo = logreg_value_from_margins(loss.b_t, Ax, x, n=loss.n)
    parts = {
        "fp64 value of x_opt": _f64_loss(A, b01, x.cpu().numpy()),
        "fp64 value of the card's fp32 margins": _f64_loss_of_margins(
            b01, Ax.double().cpu().numpy()),
        "the card's fp32 terms averaged in fp64": float(
            terms.double().mean()),
        "the card's two-float reading": float(hi) + float(lo),
    }
    print("dense: offsets from the fp64 optimum: " + "; ".join(
        f"{k} {v - f_star:.3e}" for k, v in parts.items()))
    lost = (parts["the card's two-float reading"]
            - parts["the card's fp32 terms averaged in fp64"])
    if not abs(lost) <= READING_SUM_TOL:
        raise RuntimeError(f"dense: scaling and summing the fp32 terms "
                           f"moved the value by {lost:.3e}")
    return {k: v - f_star for k, v in parts.items()}


def _iterates_f64(A, b, trace):
    b01 = (np.asarray(b) > 0).astype(np.float64)
    return [_f64_loss(A, b01, x.cpu().numpy() if hasattr(x, "cpu") else x)
            for x in trace.iterates()]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from krylov_crn_tpu_torch.utils.profiling import card_description

    card = card_description()
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
    for name, log in _kernels.last_build_log.items():
        for fn, regs in _ptxas_registers(log):
            print(f"build: {name}.cu {fn}: {regs}")
    return s


def _ptxas_registers(log):
    """(kernel, "N registers, S bytes spill stores ...") from the output
    of nvcc -Xptxas=-v."""
    import re

    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, line.split(":", 1)[1].strip()))
    return out


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
        err = _hold_to_plain(f"kernel n={n}", y, yp, ref)
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


def _gram_race(tag, name, dev):
    """The Gram-space main path on the stand-in ``name``: device K build,
    the m=10 race with certification, f* from an m=20 run on the same K,
    and the gates of phases ``main`` and ``news20``."""
    import torch

    from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.symv import symv

    t0 = time.perf_counter()
    A, b = synthetic_logreg(name, seed=0)
    gen_s = time.perf_counter() - t0
    x0 = np.ones(A.shape[1]) * 0.5
    print(f"{tag}: {name} {A.shape} nnz {A.nnz} generated in {gen_s:.2f} s")
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
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
    print(f"{tag}: K build {build_s:.3f} s (n_pad {alg.gd.n_padded}), race "
          f"{race_s:.3f} s for {alg.it} iterations, f* run {fstar_s:.3f} s")
    print(f"{tag}: f* {f_star:.17g}; crossing at iteration {cross} "
          f"(t {it_to_t.get(cross, float('nan')):.3f} s into the race); "
          f"final certified gap {gaps[-1]:.3e}, best {min(gaps):.3e}")
    print(f"{tag}: boundary exact values {bfs}; rollbacks "
          f"{trace.metrics['rollback_its']}; chunks "
          f"{len(bfs) + len(trace.metrics['rollback_its'])}")
    print(f"{tag}: symv launches {launches} (race {race_launches}), "
          f"k_matvec calls on the card {calls}")
    if not (launches == calls and race_launches > 0):
        raise RuntimeError(f"{tag}: K-matvecs bypassed the kernel: "
                           f"{launches} launches vs {calls} calls")
    if cross is None or cross > 48:
        raise RuntimeError(f"{tag}: no certified {GAP} gap within 48 "
                           f"iterations (best {min(gaps):.3e})")
    if any(b2 > b1 for b1, b2 in zip(bfs, bfs[1:])):
        raise RuntimeError(f"{tag}: exact boundary values increased: {bfs}")
    lv = np.asarray(trace.loss_vals)
    if lv.shape != (alg.it + 1,) or not np.all(np.isfinite(lv)):
        raise RuntimeError(f"{tag}: bad loss trace: shape {lv.shape}")
    return alg, dict(gen_s=gen_s, build_s=build_s, race_s=race_s,
                     fstar_s=fstar_s, iterations=alg.it, crossing_it=cross,
                     crossing_t=it_to_t.get(cross), f_star=f_star,
                     final_gap=gaps[-1], best_gap=min(gaps),
                     exact_its=its, exact_fs=fs, boundary_fs=bfs,
                     launches=launches,
                     race_launches=race_launches, kmatvec_calls=calls)


def phase_main(dev):
    return _gram_race("main", "rcv1-like", dev)


def phase_news20(dev):
    """The news20-like stand-in (19,996 x 1,355,191, 22 build panels):
    the same protocol and gates as ``main`` at d = 1.36M."""
    return _gram_race("news20", "news20-like", dev)


def phase_kernel_on_K(dev, K, tag="rcv1-like"):
    """SYMV against its plain version, fp64 and ``torch.mv`` on a K that
    a driven path built (``tag`` names the path's problem), with times."""
    import torch

    from krylov_crn_tpu_torch.ops.symv import symv, symv_plain
    from krylov_crn_tpu_torch.utils.profiling import (
        alternating_ms,
        device_time_per_call,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand(K.shape[0], generator=gen, device=dev)
    y, yp = symv(K, x), symv_plain(K, x)
    ref = K.double() @ x.double()
    rel, rel_plain = _rel(y, ref), _rel(yp, ref)
    err = _hold_to_plain(f"kernel@K {tag}", y, yp, ref)
    if not rel < SYMV_TOL:
        raise RuntimeError(f"symv rel err {rel:.3e} on {tag}'s K")
    kms, pms = alternating_ms(lambda v: symv(K, v),
                               lambda v: symv_plain(K, v), x)
    ms, plain_ms = min(kms), min(pms)
    library_ms = device_time_per_call(lambda v: torch.mv(K, v), x)
    n = K.shape[0]
    # the function needs the upper 64 x 64 tiles of the symmetric K once,
    # x once and y once; 2 n^2 operations
    bound_ms, bound_by = _bound(n * (n + 64) * 2 + 8 * n, 2 * n * n)
    print(f"kernel@K {tag} n={n}: rel err {rel:.3e} (plain {rel_plain:.3e}), max "
          f"|kernel - plain| {err:.3e}; kernel {kms} ms, plain K @ x "
          f"{pms} ms, torch.mv {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by} ({n * (n + 64) * 2 / 1e6:.0f} MB of upper tiles), "
          f"share {bound_ms / ms:.1%} "
          f"-> {n * (n + 64) * 2 / (ms * 1e-3) / 1e9:.0f} GB/s")
    return dict(rel_err=rel, rel_err_plain=rel_plain, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, ms_runs=kms, plain_ms_runs=pms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


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
        loss = LogisticRegression(A, b, dtype=dtype, device=device)
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


DIV_N = 49749  # w8a's rows: fl32(1/n) * n != 1


def phase_division(dev):
    """Division by n on the card: over_n (the JAX package's product with
    fl32(1/n), at every site but the value) and div_n (true division, the
    d-space value) give the CPU's bits at n = 49,749, where the two forms
    differ; the gradient and the HVP equal their A^T products times
    fl32(1/n) on the CPU, bit for bit."""
    import scipy.sparse as sp
    import torch

    from krylov_crn_tpu_torch import LogisticRegression
    from krylov_crn_tpu_torch.ops.math import div_n, over_n, sigmoid
    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse, rmatvec, spmv

    rng = np.random.default_rng(0)
    t = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** rng.uniform(-3, 3, 1 << 16))
                         .astype(np.float32))
    product_ok = torch.equal(over_n(t.to(dev), DIV_N).cpu(),
                             over_n(t, DIV_N))
    true_ok = torch.equal(div_n(t.to(dev), DIV_N).cpu(), t / DIV_N)
    forms_differ = int((over_n(t, DIV_N) != t / DIV_N).sum())
    A = sp.random(DIV_N, 60, density=0.05, random_state=3, format="csr",
                  data_rvs=rng.standard_normal)
    b = np.where(rng.random(DIV_N) < 0.5, 1.0, -1.0)
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    x = torch.from_numpy((rng.standard_normal(60) * 0.1).astype(np.float32)
                         ).to(dev)
    Ax = spmv(loss.data, x)
    r = rmatvec(loss.data, sigmoid(Ax) - loss.b_t)
    grad_ok = torch.equal(loss.gradient(x).cpu(), over_n(r.cpu(), DIV_N))
    w = sigmoid(Ax) * (1.0 - sigmoid(Ax))
    q = rmatvec(loss.data, w * spmv(loss.data, x))
    hvp_ok = torch.equal(hvp_sparse(loss.data, w, x).cpu(),
                         over_n(q.cpu(), DIV_N))
    print(f"division: at n = {DIV_N} the card gives the CPU's bits for "
          f"over_n {product_ok} and div_n {true_ok}; the two forms differ "
          f"in {forms_differ} of {t.numel()}; gradient {grad_ok}, HVP "
          f"{hvp_ok} (the CPU's over_n of the card's A^T products)")
    if not (product_ok and true_ok and grad_ok and hvp_ok):
        raise RuntimeError("division: the card's division by n is not the "
                           "CPU's")
    if not forms_differ:
        raise RuntimeError("division: the two forms agree at this n; the "
                           "gate would not see a mix-up")
    return dict(product=product_ok, true_division=true_ok,
                forms_differ=forms_differ, gradient=grad_ok, hvp=hvp_ok)


ROLLBACK_ITS = 12


def phase_rollback(dev):
    """GramCRN through its trust-but-verify rollback on the card: a
    300 x 700 problem with l2 = 1e-2 reaches its fp32 floor within a few
    iterations, and an accepted step then raises the exact value. Requires
    a rollback, the verified snapshot's gamma and zeta and the raised reg
    restored bit for bit, and exact values that never rise."""
    import scipy.sparse as sp
    import torch

    from krylov_crn_tpu_torch import GramCRN, LogisticRegression
    from krylov_crn_tpu_torch.solvers.crn_gram import watch_rollbacks

    rng = np.random.default_rng(11)
    n, d = 300, 700
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.4 * rng.standard_normal(n) > 0, 1.0, -1.0)
    alg = GramCRN(loss=LogisticRegression(sp.csr_matrix(Ad), b, l2=1e-2,
                                          dtype=np.float32, device=dev),
                  reg_coef=1e-3, tolerance=0, device=dev)
    checks = watch_rollbacks(alg)
    _reset_counts()
    t0 = time.perf_counter()
    tr = alg.run(np.ones(d) * 0.5, it_max=ROLLBACK_ITS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cnt = _counts()
    m = tr.metrics
    rb, fs = m.get("rollback_its", []), list(m["exact_fs"])
    print(f"rollback: GramCRN fp32 {alg.it} iterations in {secs:.3f} s; "
          f"rollbacks at iterations {rb}; restored bitwise "
          f"{[c['restored'] for c in checks]}; exact values "
          f"{[f - fs[-1] for f in fs]} above the last; CG iterations "
          f"{m['cg_its']}; symv launches {cnt['symv']}, k_matvec calls on "
          f"the card {cnt['kmatvec_calls']}")
    if not rb:
        raise RuntimeError("rollback: GramCRN never rolled back")
    if not (len(checks) == len(rb) and all(c["restored"] for c in checks)):
        raise RuntimeError("rollback: the state after a rollback is not the "
                           "verified snapshot")
    if any(f2 > f1 for f1, f2 in zip(fs, fs[1:])):
        raise RuntimeError(f"rollback: exact values increased: {fs}")
    if not (cnt["symv"] == cnt["kmatvec_calls"] and cnt["symv"] > 0):
        raise RuntimeError("rollback: K-matvecs bypassed the kernel")
    return dict(seconds=secs, rollback_its=list(rb),
                restored=[c["restored"] for c in checks], exact_fs=fs,
                cg_its=list(m["cg_its"]), launches=cnt["symv"],
                kmatvec_calls=cnt["kmatvec_calls"])


def phase_matvec(dev):
    """The dense matvec kernel against plain and fp64 at the d-space and
    tool shapes; timed at n = 20480, on the band and on w8a's padded
    copies, each call finding the L2 cache cold (as on the solvers' paths,
    where other data streams between two products)."""
    import torch

    from krylov_crn_tpu_torch.data.formats import padded_dense
    from krylov_crn_tpu_torch.ops.matvec import (
        blocks_per_sm,
        matvec,
        matvec_plain,
        smem_bytes,
        split_plan,
    )
    from krylov_crn_tpu_torch.utils.profiling import (
        alternating_ms,
        device_time_per_call,
    )

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"cases": {}, "max_abs_err": 0.0}
    # (5120, 20480): the row band of rcv1-like's K under a mesh of four
    for n, m in ((20480, 20480), (5120, 20480), (49749, 300), (300, 49749),
                 (1003, 3333)):
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
            smem = smem_bytes(plan, K.element_size())
            print(f"matvec {key}: plan {tuple(plan)}, {smem} B of shared "
                  f"memory, {blocks_per_sm(K, smem)} blocks per SM; rel err "
                  f"{rel:.3e} (plain {rel_plain:.3e}), max |kernel - plain| "
                  f"{err:.3e}")
            if not rel < MATVEC_TOL:
                raise RuntimeError(f"matvec rel err {rel:.3e} at {key}")
            if not torch.equal(y, y2):
                raise RuntimeError(f"matvec not bitwise reproducible at {key}")
            out["cases"][key] = dict(plan=tuple(plan), rel_err=rel,
                                     rel_err_plain=rel_plain, max_abs_err=err)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if m == 20480 and (n == 20480 or dtype == torch.float32):
                kms, pms = alternating_ms(lambda v: matvec(K, v),
                                           lambda v: matvec_plain(K, v), x,
                                           flush_l2=True)
                out[f"ms_{key}"], out[f"plain_ms_{key}"] = kms, pms
                # one PyTorch call for the same function: torch.mv in fp32;
                # on bf16 K with fp32 x it is the plain version's upcast
                # (torch.mv on bf16 K rounds x and y to bf16: another
                # function)
                lib = device_time_per_call(
                    (lambda v: torch.mv(K, v)) if dtype == torch.float32
                    else (lambda v: torch.mv(K.float(), v)), x,
                    flush_l2=True)
                bound_ms, bound_by = _matvec_bound(n, m, K.element_size())
                out[f"library_ms_{key}"] = lib
                out[f"bound_{key}"] = (bound_ms, bound_by)
                print(f"matvec {key}: kernel {kms} ms, plain {pms} ms, "
                      f"library {lib:.4f} ms; bound {bound_ms:.4f} ms by "
                      f"{bound_by}, share {bound_ms / min(kms):.1%}")
            del K
        del K32
    # the solver's operands: w8a-like's padded dense copies of A and A^T
    Ad = torch.randn((49749, 300), generator=gen, device=dev)
    for name, M in (("w8a_A", Ad), ("w8a_At", Ad.T)):
        K = padded_dense(M, dev)
        x = torch.randn(K.shape[1], generator=gen, device=dev)
        kms, pms = alternating_ms(lambda v: matvec(K, v),
                                   lambda v: matvec_plain(K, v), x,
                                   flush_l2=True)
        out[f"ms_{name}"], out[f"plain_ms_{name}"] = kms, pms
        lib = device_time_per_call(lambda v: torch.mv(K, v), x,
                                   flush_l2=True)
        bound_ms, bound_by = _matvec_bound(K.shape[0], K.shape[1], 4)
        out[f"library_ms_{name}"] = lib
        out[f"bound_{name}"] = (bound_ms, bound_by)
        print(f"matvec {name} {tuple(K.shape)} fp32 (ld {K.stride(0)}): "
              f"kernel {kms} ms, plain {pms} ms, torch.mv {lib:.4f} ms; "
              f"bound {bound_ms:.4f} ms by {bound_by}, share "
              f"{bound_ms / min(kms):.1%}")
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

    A, b = synthetic_logreg("w8a-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    t0 = time.perf_counter()
    _, tr64, _ = _dspace_run(CubicNewton, LogisticRegression(
        A, b, dtype=np.float64, device="cpu"), x0, 20, cubic_solver="full")
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
    _reset_counts()
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
    cnt = _counts()
    launches, calls = cnt["matvec"], cnt["dense_calls"]
    print(f"dense: matvec launches {launches} ({cnt['matvec_shapes']}), "
          f"dense-branch products on the card {calls}, symv launches "
          f"{cnt['symv']}")
    if not (launches == calls and launches > 0):
        raise RuntimeError(f"dense products bypassed the kernel: {launches} "
                           f"launches vs {calls} calls")
    out.update(launches=launches, dense_calls=calls,
               matvec_shapes=cnt["matvec_shapes"],
               reading_offset=_reading_offset("dense", float(loss.f_opt),
                                              f_star),
               reading_parts=_reading_parts(loss, A, b, f_star))
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


def _reset_counts():
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.ops.spmv import dense_matvec
    from krylov_crn_tpu_torch.ops.symv import symv

    symv.launches = k_matvec.cuda_calls = 0
    matvec.launches = dense_matvec.cuda_calls = 0
    matvec.shape_launches = {}


def _counts():
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.ops.spmv import dense_matvec
    from krylov_crn_tpu_torch.ops.symv import symv

    return dict(symv=symv.launches, kmatvec_calls=k_matvec.cuda_calls,
                matvec=matvec.launches, dense_calls=dense_matvec.cuda_calls,
                matvec_shapes={f"{n}x{m}_{dt}": k for (n, m, dt), k
                               in matvec.shape_launches.items()})


def _jax_sscn_curve(m):
    """The JAX package's fp32 SSCN exact gaps on rcv1-like (the Figure-2
    artifact, recorded on a TPU; counts only), or None without it."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "figure2", "rcv1-like.json")
    try:
        with open(path) as fh:
            art = json.load(fh)
        c = art["legs"]["tpu-fp32"]["curves"][f"SSCN (m={m})"]
        return [f - art["f_star"] for f in c["exact_fs"]]
    except (OSError, KeyError, ValueError):
        return None


def phase_cli_gram(f_star):
    """The CLI's run grid on rcv1-like, on the card, at full width."""
    import torch

    from krylov_crn_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "--dataset", "rcv1_train.binary", "--synthetic",
        "--it_max", str(CLI_GRAM_ITS), "--time_max", "100000",
        "--SSCN_dim", "500", "--no-bench-run"])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    grid = cli.run_grid(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cnt = _counts()
    crn, sscn, kry = grid.crn, grid.sscn[0], grid.krylov
    if type(crn).__name__ != "GramCRN" or not grid.use_gram:
        raise RuntimeError(f"cli_gram ran {type(crn).__name__}, not GramCRN")
    m = crn.trace.metrics
    its, fs = list(m["exact_its"]), [float(v) for v in m["exact_fs"]]
    gaps = [f - f_star for f in fs]
    cross = next((it for it, g in zip(its, gaps) if g <= GAP), None)
    ts = list(crn.trace.ts)
    per_it = (ts[-1] / crn.it) if crn.it else float("nan")
    print(f"cli_gram: run_grid {secs:.3f} s; GramCRN {crn.it} iterations in "
          f"{ts[-1]:.3f} s ({per_it:.3f} s per iteration)")
    it_to_t = dict(zip(crn.trace.its, ts))
    it_secs = [it_to_t.get(i, np.nan) - it_to_t.get(i - 1, np.nan)
               for i in range(1, crn.it + 1)]
    for i, (g, cg, rd) in enumerate(zip(gaps, m["cg_its"],
                                        m["host_reads"]), 1):
        print(f"cli_gram: GramCRN it {i}: {it_secs[i - 1]:.3f} s, exact gap "
              f"{g:.3e}, CG iterations {cg}, host reads {rd}")
    print(f"cli_gram: GramCRN crossing at iteration {cross}; final gap "
          f"{gaps[-1]:.3e}; rollbacks {m.get('rollback_its', [])}; "
          f"solver_it {int(crn.state.solver_it)}")
    sv = np.asarray(sscn.trace.loss_vals, np.float64)
    s_gap = float(sv[-1]) - f_star
    jax_curve = _jax_sscn_curve(500)
    jax_gap = (jax_curve[sscn.it] if jax_curve and sscn.it < len(jax_curve)
               else None)
    print(f"cli_gram: SSCN m=500 {sscn.it} iterations in "
          f"{sscn.trace.ts[-1]:.3f} s, gap {s_gap:.4e} (the JAX package's "
          f"m=500 curve at iteration {sscn.it}: {jax_gap}), solver_it "
          f"{int(sscn.state.solver_it)}")
    kv = np.asarray(kry.trace.loss_vals, np.float64)
    print(f"cli_gram: GramKrylov {kry.it} iterations, exact "
          f"{kry.trace.metrics['exact_fs'][-1] - f_star:.3e} gap; f* of the "
          f"grid {grid.f_opt:.17g}")
    print(f"cli_gram: symv launches {cnt['symv']}, k_matvec calls on the "
          f"card {cnt['kmatvec_calls']}, matvec launches {cnt['matvec']}")
    if not (cnt["symv"] == cnt["kmatvec_calls"] and cnt["symv"] > 0):
        raise RuntimeError(f"cli_gram: K-matvecs bypassed the kernel: "
                           f"{cnt['symv']} launches vs "
                           f"{cnt['kmatvec_calls']} calls")
    if cross is None or cross > CLI_GRAM_ITS:
        raise RuntimeError(f"cli_gram: no certified {GAP} gap within "
                           f"{CLI_GRAM_ITS} iterations (best {min(gaps):.3e})")
    if any(f2 > f1 for f1, f2 in zip(fs, fs[1:])):
        raise RuntimeError(f"cli_gram: GramCRN exact values increased: {fs}")
    if not (np.all(np.isfinite(sv)) and np.all(np.isfinite(kv))):
        raise RuntimeError("cli_gram: non-finite SSCN or Krylov losses")
    return dict(seconds=secs, crn_iterations=crn.it, crn_seconds=ts[-1],
                crn_s_per_it=per_it, crn_it_seconds=it_secs,
                crossing_it=cross, exact_gaps=gaps,
                cg_its=list(m["cg_its"]), host_reads=list(m["host_reads"]),
                rollback_its=list(m.get("rollback_its", [])),
                sscn_gap=s_gap, sscn_jax_gap=jax_gap,
                sscn_seconds=sscn.trace.ts[-1], f_opt=grid.f_opt,
                launches=cnt["symv"], kmatvec_calls=cnt["kmatvec_calls"])


def phase_sscn(dev):
    """SSCN m=500 on rcv1-like: two fp32 card runs and one fp64 CPU run
    from one generator seed."""
    import torch

    from krylov_crn_tpu_torch import SSCN, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    runs = {}
    _reset_counts()
    for key, dtype, device in (("f32_card", np.float32, dev),
                               ("f32_card_again", np.float32, dev),
                               ("f64_cpu", np.float64, "cpu")):
        loss = LogisticRegression(A, b, dtype=dtype, device=device)
        if loss.data.dense is not None:
            raise RuntimeError("rcv1-like must take the CSR branch")
        alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=500, tolerance=0)
        alg.init_run(x0, 42)
        alg.initialized = True
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        alg.run(x0, it_max=SSCN_ITS)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        x = alg.state.x.cpu().numpy()
        f = _f64_loss(A, loss.b.astype(np.float64), x)
        runs[key] = dict(x=alg.state.x, seconds=secs, f=f,
                         solver_it=int(alg.state.solver_it))
        print(f"sscn {key}: {SSCN_ITS} iterations in {secs:.3f} s "
              f"({secs / SSCN_ITS * 1e3:.1f} ms per step), solver_it "
              f"{runs[key]['solver_it']}, fp64 loss of the last iterate "
              f"{f:.17g}")
    cnt = _counts()
    same = torch.equal(runs["f32_card"]["x"], runs["f32_card_again"]["x"])
    f64, f32 = runs["f64_cpu"]["f"], runs["f32_card"]["f"]
    rel = abs(f32 - f64) / abs(f64)
    print(f"sscn: fp32 card vs fp64 CPU, relative {rel:.3e}; two card runs "
          f"bitwise equal: {same}; dense products {cnt['dense_calls']}")
    if not same:
        raise RuntimeError("sscn: two fp32 card runs differ")
    if cnt["dense_calls"]:
        raise RuntimeError("sscn: the CSR path ran dense products")
    if not rel <= SPARSE_REL_TOL:
        raise RuntimeError(f"sscn: fp32 card loss {f32!r} vs fp64 CPU "
                           f"{f64!r}: relative {rel:.3e}")
    return dict(f64_cpu=f64, f32_card=f32, rel=rel, runs_equal=same,
                seconds={k: r["seconds"] for k, r in runs.items()},
                solver_it={k: r["solver_it"] for k, r in runs.items()})


def phase_cli_dense():
    """The CLI's run grid on w8a-like: the d-space path on the card."""
    import torch

    from krylov_crn_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "--dataset", "w8a", "--synthetic", "--it_max", "20",
        "--time_max", "100000", "--SSCN_dim", "10", "--no-bench-run"])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    grid = cli.run_grid(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cnt = _counts()
    if grid.use_gram or getattr(grid.crn, "cubic_solver", None) != "full":
        raise RuntimeError("cli_dense must run the d-space path, CRN full")
    A, b01 = grid.loss.A_host, grid.loss.b.astype(np.float64)
    gaps = {}
    for name, alg in (("crn", grid.crn), ("sscn", grid.sscn[0]),
                      ("krylov", grid.krylov)):
        gaps[name] = _f64_loss(A, b01, alg.state.x.cpu().numpy()) \
            - W8A_F_STAR
        print(f"cli_dense: {name} {alg.it} iterations in "
              f"{alg.trace.ts[-1]:.3f} s, final fp64 gap {gaps[name]:.3e}")
    print(f"cli_dense: run_grid {secs:.3f} s; matvec launches "
          f"{cnt['matvec']}, dense-branch products on the card "
          f"{cnt['dense_calls']}, symv launches {cnt['symv']}")
    if not (cnt["matvec"] == cnt["dense_calls"] and cnt["matvec"] > 0):
        raise RuntimeError(f"cli_dense: dense products bypassed the kernel: "
                           f"{cnt['matvec']} launches vs "
                           f"{cnt['dense_calls']} calls")
    if not gaps["crn"] <= DSPACE_GAP:
        raise RuntimeError(f"cli_dense: CRN final gap {gaps['crn']:.3e} "
                           f"above {DSPACE_GAP}")
    if not all(np.isfinite(g) for g in gaps.values()):
        raise RuntimeError(f"cli_dense: non-finite gaps {gaps}")
    return dict(seconds=secs, gaps=gaps, launches=cnt["matvec"],
                dense_calls=cnt["dense_calls"],
                matvec_shapes=cnt["matvec_shapes"])


def phase_skew(dev):
    """The K build under heavy column skew: the power-law problem at
    rcv1's shape, whose first panel holds three quarters of the entries
    (the JAX package leaves its panel scan for such input)."""
    import torch

    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import (
        _pack_flat_panels,
        build_K_device,
        _heavy_skew,
        pad_rows,
    )
    from krylov_crn_tpu_torch.ops.symv import symv, symv_plain

    A, _ = synthetic_logreg((20242, 47236, 1342290), seed=0,
                            profile="powerlaw")
    n = A.shape[0]
    n_pad = pad_rows(n)
    *_, lens, _, nblk = _pack_flat_panels(A, n_pad, np.float32)
    print(f"skew: {A.shape} nnz {A.nnz}, {nblk} panels, longest "
          f"{int(lens.max())} entries, _heavy_skew "
          f"{_heavy_skew(lens, A.nnz)}")
    if not _heavy_skew(lens, A.nnz):
        raise RuntimeError("skew: the problem is not a skewed one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K = build_K_device(A, n_pad, np.float32, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not torch.equal(K, K.T):
        raise RuntimeError("skew: K is not bitwise symmetric")
    rows = np.sort(np.random.default_rng(0).choice(n, 4096, replace=False))
    want = torch.from_numpy((A[rows].astype(np.float64)
                             @ A.astype(np.float64).T).toarray()).to(dev)
    got = K[torch.from_numpy(rows).to(dev), :n].double()
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    x = torch.rand(n_pad, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)
    y, yp = symv(K, x), symv_plain(K, x)
    ref = K.double() @ x.double()
    symv_rel = _rel(y, ref)
    err = _hold_to_plain("skew", y, yp, ref)
    print(f"skew: K build {build_s:.3f} s; 4,096 sampled rows against host "
          f"A A^T rel {rel:.3e}; bitwise symmetric; symv on it rel "
          f"{symv_rel:.3e} of fp64 (plain {_rel(yp, ref):.3e}), max |kernel "
          f"- plain| {err:.3e}")
    if not rel <= SKEW_K_TOL:
        raise RuntimeError(f"skew: K rel err {rel:.3e} above {SKEW_K_TOL}")
    if not symv_rel < SYMV_TOL:
        raise RuntimeError(f"skew: symv rel err {symv_rel:.3e}")
    return dict(build_s=build_s, rel_err=rel, symv_rel_err=symv_rel,
                max_abs_err=err,
                nnz=int(A.nnz), panels=int(nblk),
                longest_panel=int(lens.max()))


def _final_gaps_ok(tag, data):
    """Every certified final gap of a merged Figure-2 JSON is finite and
    not below -1e-12; returns the one leg's gaps."""
    if "f_star" not in data or not np.isfinite(data["f_star"]):
        raise RuntimeError(f"{tag}: the JSON has no finite f_star")
    (gaps,) = data["final_gaps"].values()
    bad = {a: g for a, g in gaps.items()
           if g is None or not np.isfinite(g) or g < -1e-12}
    if bad:
        raise RuntimeError(f"{tag}: bad final gaps {bad}")
    return gaps


def phase_figure2(news20_alg):
    """The Figure-2 tool's functions on the card: w8a-like whole (grid
    (100, [10])), and news20-like without GramCRN (GramKrylov m=10 for 50
    iterations on phase ``news20``'s K, SSCN m=1000 for 50), each merged
    with nothing into a JSON of its own."""
    import tempfile

    import torch

    from krylov_crn_tpu_torch.tools import run_figure2 as rf

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- w8a-like, the whole grid (d-space path, matvec kernel)
        name = "w8a-like"
        it_max, dims = rf.GRID[name]
        A, b, x0 = rf.build_problem(name)
        _reset_counts()
        t0 = time.perf_counter()
        curves, f_best = rf.run_ours(A, b, x0, it_max, dims, np.float32)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        cnt = _counts()
        data = rf.merge_json(
            f"{tmp}/{name}.json", name, "h100-fp32", curves, f_best,
            rf.leg_meta(name, A, it_max, "h100-fp32", None))
        gaps = _final_gaps_ok("figure2 w8a-like", data)
        reading = min(min(c["fs"]) for c in curves.values())
        off = _reading_offset("figure2 w8a-like", reading, data["f_star"])
        print(f"figure2 w8a-like: {secs:.3f} s; f* {data['f_star']:.17g} "
              f"(the JAX package's {W8A_F_STAR:.17g}); final gaps {gaps}; "
              f"iterations { {a: c['its'][-1] for a, c in curves.items()} }; "
              f"matvec launches {cnt['matvec']}, dense-branch products on "
              f"the card {cnt['dense_calls']}")
        if not (cnt["matvec"] == cnt["dense_calls"] and cnt["matvec"] > 0):
            raise RuntimeError("figure2 w8a-like: dense products bypassed "
                               "the kernel")
        for alg in ("CRN", "Krylov CRN (m=10)"):
            if not gaps[alg] <= DSPACE_GAP:
                raise RuntimeError(f"figure2 w8a-like: {alg} final gap "
                                   f"{gaps[alg]:.3e} above {DSPACE_GAP}")
        out[name] = dict(seconds=secs, f_star=data["f_star"], final_gaps=gaps,
                         reading_offset=off,
                         matvec_launches=cnt["matvec"],
                         matvec_shapes=cnt["matvec_shapes"],
                         dense_calls=cnt["dense_calls"],
                         ts={a: c["ts"][-1] for a, c in curves.items()})

        # ---- news20-like: GramKrylov m=10 (SYMV) and SSCN m=1000
        name = "news20-like"
        loss = news20_alg.loss
        A, b = loss.A_host, loss.b
        x0 = np.ones(A.shape[1]) * 0.5
        curves = {}
        _reset_counts()
        t0 = time.perf_counter()
        curves["Krylov CRN (m=10)"], kry = rf.run_krylov(
            loss, b, x0, 50, gram=True, m=10, gram_data=news20_alg.gd)
        torch.cuda.synchronize()
        kry_s = time.perf_counter() - t0
        cnt = _counts()
        if not (cnt["symv"] == cnt["kmatvec_calls"] and cnt["symv"] > 0):
            raise RuntimeError("figure2 news20-like: K-matvecs bypassed the "
                               "kernel")
        t0 = time.perf_counter()
        curves["SSCN (m=1000)"], sscn = rf.run_sscn(loss, b, x0, 50, 1000)
        torch.cuda.synchronize()
        sscn_s = time.perf_counter() - t0
        sscn_ts = curves["SSCN (m=1000)"]["ts"]
        data = rf.merge_json(
            f"{tmp}/{name}.json", name, "h100-fp32", curves,
            rf.leg_f_best(loss, curves),
            rf.leg_meta(name, A, 50, "h100-fp32", None))
        gaps = _final_gaps_ok("figure2 news20-like", data)
        print(f"figure2 news20-like: GramKrylov m=10 {kry.it} iterations "
              f"certified in {kry_s:.3f} s, symv launches {cnt['symv']}; "
              f"SSCN m=1000 {sscn.it} iterations in {sscn_ts[-1]:.3f} s "
              f"({sscn_ts[-1] / max(sscn.it, 1) * 1e3:.1f} ms per step; "
              f"{sscn_s:.3f} s with warm-up and fp64 certification), "
              f"solver_it {int(sscn.state.solver_it)}; f* "
              f"{data['f_star']:.17g}; final gaps {gaps}")
        out[name] = dict(krylov_seconds=kry_s, sscn_seconds=sscn_s,
                         sscn_run_seconds=sscn_ts[-1],
                         sscn_ms_per_step=sscn_ts[-1] / max(sscn.it, 1) * 1e3,
                         f_star=data["f_star"], final_gaps=gaps,
                         launches=cnt["symv"],
                         kmatvec_calls=cnt["kmatvec_calls"])
    return out


def phase_stress1m(dev, card):
    """The stress-1m sparse HVP (1M x 1M, 100M power-law entries made on
    the card; CSR products, neither hand-written kernel), checked at a
    tenth of the size against fp64 on the host, then timed at full size."""
    import scipy.sparse as sp
    import torch

    from krylov_crn_tpu_torch.ops.spmv import hvp_sparse, spmv
    from krylov_crn_tpu_torch.tools import measure_large_n as tool

    # a tenth of the size, same generator: the card against scipy in fp64
    n = d = 100_000
    nnz = 10_000_000
    rows, cols, vals = tool.device_powerlaw_coo(n, d, nnz, device=dev)
    from krylov_crn_tpu_torch.data.formats import dual_from_coo

    data = dual_from_coo(rows, cols, vals, n, d)
    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.rand(n, generator=gen, device=dev)
    v = torch.randn(d, generator=gen, device=dev)
    got = hvp_sparse(data, w, v).double().cpu().numpy()
    M = sp.coo_matrix((vals.double().cpu().numpy(),
                       (rows.cpu().numpy(), cols.cpu().numpy())),
                      shape=(n, d)).tocsr()
    want = M.T @ (w.double().cpu().numpy()
                  * (M @ v.double().cpu().numpy())) / n
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"stress1m: {n} x {d}, {nnz} entries: card HVP against fp64 scipy "
          f"rel {rel:.3e}")
    if not rel <= STRESS_REL_TOL:
        raise RuntimeError(f"stress1m: HVP rel err {rel:.3e} at a tenth of "
                           "the size")
    del data, rows, cols, vals, M
    torch.cuda.empty_cache()

    n = d = 1_000_000
    nnz = 100_000_000
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = tool.build_device_dual(n, d, nnz, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w = torch.rand(n, generator=gen, device=dev)
    v = torch.randn(d, generator=gen, device=dev)
    u = torch.randn(d, generator=gen, device=dev)
    y1, y2 = hvp_sparse(data, w, v), hvp_sparse(data, w, v)
    if not torch.equal(y1, y2):
        raise RuntimeError("stress1m: two card HVPs differ")
    if not bool(torch.isfinite(y1).all()):
        raise RuntimeError("stress1m: non-finite HVP entries")
    # u^T (A^T (w * A v)) = (A u)^T (w * A v), both summed in fp64
    lhs = float(torch.dot(u.double(), y1.double() * n))
    rhs = float(torch.dot(spmv(data, u).double(),
                          (w * spmv(data, v)).double()))
    adj = abs(lhs - rhs) / abs(rhs)
    row = tool.result_row(n, d, nnz, build_s, tool.measure_hvp(data),
                          card)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"stress1m: two HVPs bitwise equal, finite; adjoint identity rel "
          f"{adj:.3e}; peak device memory {peak_gb:.2f} GB")
    print(f"stress1m: {json.dumps(row)}")
    print(f"stress1m: HVP {row['hvp_s'] * 1e3:.3f} ms against a bound of "
          f"{row['bound_ms']:.3f} ms (A and A^T once with int32 column "
          f"indices, w and v in, the result out, 3.35 TB/s): "
          f"{row['share_of_bound']:.1%} of it; the format streams int64 "
          f"indices, {row['format_bound_ms']:.3f} ms: "
          f"{row['share_of_format_bound']:.1%}")
    if not adj <= STRESS_ADJ_TOL:
        raise RuntimeError(f"stress1m: adjoint identity off by {adj:.3e}")
    del data
    torch.cuda.empty_cache()
    return dict(row, rel_err_tenth=rel, adjoint_rel=adj, peak_gb=peak_gb)


def _mesh_rank(mesh):
    """One rank of phase ``mesh``, parts (b) and (c): the rcv1-like Gram
    race on a row-banded K, the band kernel against its plain version,
    and the row-sharded d-space Krylov and SSCN runs."""
    import torch

    from krylov_crn_tpu_torch import (
        SSCN,
        CubicKrylov,
        GramKrylov,
        LogisticRegression,
    )
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.matvec import matvec, matvec_plain
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.parallel.sharded import build_sharded_dual
    from krylov_crn_tpu_torch.solvers.krylov_gram import gram_krylov_step

    dev = mesh.device
    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    out = {"rank": mesh.rank}

    # (b) the Gram race on the row-banded K
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     mesh=mesh, label="gram-mesh")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg.init_run(x0, 42)
    alg.initialized = True
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    matvec.launches = symv.launches = 0
    k_matvec.band_cuda_calls = k_matvec.cuda_calls = 0
    mesh.reset_counts()
    t0 = time.perf_counter()
    trace = alg.run_fused(x0, it_max=48, chunk=24, certify=True)
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    m = trace.metrics
    out["race"] = dict(
        build_s=build_s, race_s=race_s, iterations=alg.it,
        band_shape=tuple(alg.gd.K.shape), n_pad=alg.gd.n_padded,
        exact_its=list(m["exact_its"]),
        exact_fs=[float(v) for v in m["exact_fs"]],
        boundary_fs=[float(v) for v in m["boundary_fs"]],
        rollback_its=list(m["rollback_its"]),
        loss_vals=[float(v) for v in trace.loss_vals],
        launches=matvec.launches, band_calls=k_matvec.band_cuda_calls,
        symv_launches=symv.launches, whole_calls=k_matvec.cuda_calls,
        counts=mesh.counts_snapshot())
    # one more step on its own: the per-step collective budget
    mesh.reset_counts()
    gram_krylov_step(alg.gd, alg.state, **alg._step_kwargs())
    out["step_counts"] = mesh.counts_snapshot()

    # this rank's band kernel against its plain version and fp64
    K = alg.gd.K
    q = torch.rand(K.shape[1], device=dev,
                   generator=torch.Generator(device=dev).manual_seed(11))
    y, y2, yp = matvec(K, q), matvec(K, q), matvec_plain(K, q)
    ref = K.double() @ q.double()
    out["band_kernel"] = dict(
        rel=_rel(y, ref), rel_plain=_rel(yp, ref),
        max_abs_err=float((y - yp).abs().max()),
        repeatable=bool(torch.equal(y, y2)))
    del alg, K, loss
    torch.cuda.empty_cache()

    # (c) the d-space CSR path, row-sharded
    sd = build_sharded_dual(A, mesh, dtype=np.float32)
    loss = LogisticRegression(sd, b)
    b01 = (np.asarray(b) > 0).astype(np.float64)
    for key, cls, its, kw in (
            ("krylov", CubicKrylov, 10, dict(subspace_dim=10)),
            ("sscn", SSCN, SSCN_ITS, dict(subspace_dim=500))):
        alg = cls(loss=loss, reg_coef=1e-3, tolerance=0, **kw)
        alg.init_run(x0, 42)
        alg.initialized = True
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alg.run(x0, it_max=its)
        torch.cuda.synchronize()
        out[key] = dict(seconds=time.perf_counter() - t0, iterations=alg.it,
                        f=_f64_loss(A, b01, alg.state.x.cpu().numpy()),
                        solver_it=int(alg.state.solver_it),
                        counts=mesh.counts_snapshot())
    out["local_rows"] = sd.row_counts[mesh.rank]
    out["local_nnz"] = sd.local.nnz
    return out


def _nccl_probe(mesh):
    """A one-rank NCCL group on the card: one all-reduce and one
    all-gather through the mesh's functions."""
    import torch
    import torch.distributed as dist

    from krylov_crn_tpu_torch.parallel.mesh import (
        Mesh,
        all_gather_rows,
        all_reduce_sum,
    )

    dev = torch.device("cuda", 0)
    one = Mesh(group=dist.group.WORLD, rank=0, world=1, device=dev,
               backend="nccl")
    t = torch.arange(4.0, device=dev)
    ar, ag = all_reduce_sum(one, t), all_gather_rows(one, t)
    torch.cuda.synchronize()
    return dict(ok=bool(torch.equal(ar, t) and torch.equal(ag, t)
                        and ar.is_cuda and ag.is_cuda),
                counts=one.counts_snapshot())


def phase_mesh(card, main_rec, sparse_rec, sscn_rec):
    """Phase 18: the multi-device layer in four ranks sharing the card."""
    import torch
    import torch.distributed as dist

    from krylov_crn_tpu_torch.graft_entry import dryrun_multidevice
    from krylov_crn_tpu_torch.parallel.launch import run_ranks
    from krylov_crn_tpu_torch.tools import stress10m_dryrun

    D = MESH_RANKS
    out = {}
    note = "four ranks time-slicing one card: a correctness run's time"

    # (e) the backends
    out["nccl_available"] = bool(dist.is_nccl_available())
    print(f"mesh: torch.distributed.is_nccl_available() = "
          f"{out['nccl_available']}")
    if out["nccl_available"]:
        (probe,) = run_ranks(_nccl_probe, 1, "nccl", "cuda:0", 300.0)
        print(f"mesh: one-rank NCCL group: all-reduce and all-gather through "
              f"the mesh ok = {probe['ok']}, counts "
              f"{ {k: v['calls'] for k, v in probe['counts'].items()} }")
        if not probe["ok"]:
            raise RuntimeError("mesh: collectives failed on a one-rank NCCL "
                               "group")
        out["probe_nccl"] = probe

    # (a) the dry run's four legs
    t0 = time.perf_counter()
    legs = dryrun_multidevice(D, "cuda:0", timeout=600.0)
    out["dryrun"] = {k: legs[0][k] for k in ("dspace", "gram", "fused",
                                             "libsvm")}
    print(f"mesh: dryrun_multidevice({D}, 'cuda:0') in "
          f"{time.perf_counter() - t0:.1f} s: {out['dryrun']}")

    # (b) and (c) in one launch
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_rank, D, "gloo", "cuda:0", 900.0)
    launch_s = time.perf_counter() - t0
    r0 = ranks[0]
    race = r0["race"]
    for r in ranks[1:]:
        for key in ("exact_its", "exact_fs", "boundary_fs", "loss_vals"):
            if r["race"][key] != race[key]:
                raise RuntimeError(f"mesh: ranks disagree on the race's {key}")
        for key in ("krylov", "sscn"):
            if (r[key]["f"], r[key]["solver_it"]) != (r0[key]["f"],
                                                      r0[key]["solver_it"]):
                raise RuntimeError(f"mesh: ranks disagree on {key}")
    f_star = main_rec["f_star"]
    gaps = [f - f_star for f in race["exact_fs"]]
    cross = next((it for it, g in zip(race["exact_its"], gaps) if g <= GAP),
                 None)
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(race["exact_fs"], main_rec["exact_fs"]))
    print(f"mesh race: rcv1-like on {D} bands {race['band_shape']} of n_pad "
          f"{race['n_pad']}: build {race['build_s']:.3f} s, race "
          f"{race['race_s']:.3f} s for {race['iterations']} iterations "
          f"({note}; launch {launch_s:.1f} s); crossing at iteration {cross} "
          f"(single device {main_rec['crossing_it']}), final gap "
          f"{gaps[-1]:.3e}, exact values within {rel:.3e} relative of the "
          f"single-device race; rollbacks {race['rollback_its']}")
    steps = race["counts"]["all_gather"]["calls"] // 11
    print(f"mesh race: per rank {race['launches']} matvec launches, "
          f"{race['band_calls']} band calls, "
          f"{race['counts']['all_gather']['calls']} all-gathers "
          f"({steps} steps x 11, "
          f"{race['counts']['all_gather']['bytes']} B), "
          f"{race['counts']['all_reduce']['calls']} all-reduces; one step: "
          f"{ {k: v['calls'] for k, v in r0['step_counts'].items()} }; symv "
          f"launches {race['symv_launches']}")
    if cross is None or cross > 48:
        raise RuntimeError(f"mesh: no certified {GAP} gap within 48 "
                           f"iterations (best {min(gaps):.3e})")
    bfs = race["boundary_fs"]
    if any(b2 > b1 for b1, b2 in zip(bfs, bfs[1:])):
        raise RuntimeError(f"mesh: exact boundary values increased: {bfs}")
    if race["exact_its"] != main_rec["exact_its"]:
        raise RuntimeError("mesh: exact_its differ from the single-device "
                           "race's")
    if not rel <= MESH_REL_TOL:
        # rounding order alone (band kernel against SYMV) sets this
        # distance: past MESH_REL_TOL the race is held to its certified
        # crossing within 48 iterations, non-increasing boundary values
        # (above) and a certified final gap within GAP (ROADMAP C.4)
        print(f"mesh: exact values {rel:.3e} relative from the "
              f"single-device race, past {MESH_REL_TOL}: held to the "
              f"certified crossing and final gap instead (ROADMAP C.4)")
        if not gaps[-1] <= GAP:
            raise RuntimeError(f"mesh: final certified gap {gaps[-1]:.3e} "
                               f"above {GAP}")
    for r in ranks:
        rc, c = r["race"], r["race"]["counts"]
        if not (rc["launches"] == rc["band_calls"]
                == c["all_gather"]["calls"] > 0
                and c["all_gather"]["calls"] % 11 == 0
                and c["all_gather"]["max_numel"] == rc["n_pad"]
                and c["all_reduce"]["calls"] == 0
                and rc["symv_launches"] == rc["whole_calls"] == 0):
            raise RuntimeError(f"mesh: rank {r['rank']} band products or "
                               f"collectives off budget: {rc}")
        sc = r["step_counts"]
        if not (sc["all_gather"]["calls"] == 11
                and sc["all_reduce"]["calls"] == 0):
            raise RuntimeError(f"mesh: one Gram step's collectives: {sc}")
        bk = r["band_kernel"]
        print(f"mesh band kernel rank {r['rank']}: rel err {bk['rel']:.3e} "
              f"(plain {bk['rel_plain']:.3e}), max |kernel - plain| "
              f"{bk['max_abs_err']:.3e}, repeatable {bk['repeatable']}")
        if not (bk["rel"] < MATVEC_TOL and bk["repeatable"]):
            raise RuntimeError(f"mesh: band kernel off on rank {r['rank']}")
    out.update(race=race, step_counts=r0["step_counts"], crossing_it=cross,
               rel_vs_single=rel, launch_s=launch_s,
               band_launches=sum(r["race"]["launches"] for r in ranks),
               band_calls=sum(r["race"]["band_calls"] for r in ranks),
               band_max_abs_err=max(r["band_kernel"]["max_abs_err"]
                                    for r in ranks))

    want = {"krylov": sparse_rec["f32_card"], "sscn": sscn_rec["f32_card"]}
    budget = {"krylov": 11 * 10, "sscn": 2 * SSCN_ITS}
    for key in ("krylov", "sscn"):
        rec = r0[key]
        rel = abs(rec["f"] - want[key]) / abs(want[key])
        ar = rec["counts"]["all_reduce"]
        print(f"mesh {key}: row-sharded rcv1-like (rows "
              f"{[r['local_rows'] for r in ranks]}, nnz "
              f"{[r['local_nnz'] for r in ranks]}): {rec['iterations']} "
              f"iterations in {rec['seconds']:.3f} s ({note}), fp64 loss of "
              f"the last iterate {rec['f']:.17g}, {rel:.3e} relative from "
              f"the single-card run; {ar['calls']} all-reduces "
              f"({ar['bytes']} B), "
              f"{rec['counts']['all_gather']['calls']} all-gathers, "
              f"solver_it {rec['solver_it']}")
        if not rel <= MESH_REL_TOL:
            raise RuntimeError(f"mesh {key}: {rel:.3e} relative from the "
                               f"single-card run (limit {MESH_REL_TOL})")
        if ar["calls"] != budget[key]:
            raise RuntimeError(f"mesh {key}: {ar['calls']} all-reduces, "
                               f"budget {budget[key]}")
        out[key] = dict(rec, rel_vs_single=rel)

    # (d) the stress-10m HVP
    t0 = time.perf_counter()
    row = stress10m_dryrun.run(10_000_000, 10_000_000, 100_000_000, D,
                               "cuda:0", timeout=900.0)
    print(f"mesh stress10m ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(row)}")
    print(f"mesh stress10m: sharded HVP {row['hvp_s'] * 1e3:.3f} ms "
          f"({note}) beside a one-card byte bound of "
          f"{row['hvp_bound_ms_one_device']:.3f} ms; "
          f"{row['all_reduces_per_hvp']} all-reduce of "
          f"{row['all_reduce_bytes_per_hvp']} B; "
          f"{row['rel_err_vs_single_device']:.3e} relative from the "
          f"single-device HVP of the same entries")
    if not row["ok"]:
        raise RuntimeError(f"mesh stress10m: {row}")
    out["stress10m"] = row
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record to this JSON")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    record = {"card": card, "build_s": phase_build(),
              "kernel": phase_kernel(dev)}
    alg, record["main"] = phase_main(dev)
    record["kernel_on_K"] = phase_kernel_on_K(dev, alg.gd.K)
    del alg
    torch.cuda.empty_cache()
    record["small"] = phase_small(dev)
    record["division"] = phase_division(dev)
    record["rollback"] = phase_rollback(dev)
    record["matvec"] = phase_matvec(dev)
    record["dense"] = phase_dense(dev)
    record["sparse"] = phase_sparse(dev)
    record["measure"] = phase_measure()
    record["cli_gram"] = phase_cli_gram(record["main"]["f_star"])
    torch.cuda.empty_cache()
    record["sscn"] = phase_sscn(dev)
    record["cli_dense"] = phase_cli_dense()
    torch.cuda.empty_cache()
    news20_alg, record["news20"] = phase_news20(dev)
    record["kernel_on_K_news20"] = phase_kernel_on_K(
        dev, news20_alg.gd.K, "news20-like")
    record["figure2"] = phase_figure2(news20_alg)
    del news20_alg
    torch.cuda.empty_cache()
    record["skew"] = phase_skew(dev)
    torch.cuda.empty_cache()
    record["stress1m"] = phase_stress1m(dev, card)
    torch.cuda.empty_cache()
    record["mesh"] = phase_mesh(card, record["main"], record["sparse"],
                                record["sscn"])
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: all phases in {record['seconds']:.1f} s")
    kk, mv, fig = record["kernel_on_K"], record["matvec"], record["figure2"]
    # the d-space paths' matvec launches by shape: w8a-like's A and A^T
    dense_runs = (record["dense"], record["cli_dense"], fig["w8a-like"])
    by_shape = {}
    for r in dense_runs:
        for key, k in r["matvec_shapes"].items():
            by_shape[key] = by_shape.get(key, 0) + k
    w8a = {"w8a_A": "49749x300_float32", "w8a_At": "300x49749_float32"}
    print(f"chip_smoke: matvec launches on the d-space paths by shape "
          f"{by_shape}")
    if sum(by_shape.values()) != sum(by_shape.get(k, 0) for k in w8a.values()):
        raise RuntimeError(f"matvec launched at other shapes: {by_shape}")

    def matvec_record(name, key, launches, max_abs_err):
        bound = mv[f"bound_{key}"]
        return {"name": name, "route": "cuda",
                "source": "krylov_crn_tpu_torch/csrc/matvec.cu",
                "replaces": "tools/measure_matvec.py:35",
                "launches": launches, "max_abs_err": max_abs_err,
                "ms": min(mv[f"ms_{key}"]),
                "plain_ms": min(mv[f"plain_ms_{key}"]),
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": mv[f"library_ms_{key}"]}

    kernels = {"kernels": [{
        "name": "symv_upper", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/symv.cu",
        "replaces": "krylov_crn_tpu/ops/symv.py:69",
        "launches": (record["main"]["launches"]
                     + record["rollback"]["launches"]
                     + record["cli_gram"]["launches"]
                     + record["news20"]["launches"]
                     + fig["news20-like"]["launches"]),
        "max_abs_err": max(kk["max_abs_err"],
                           record["kernel_on_K_news20"]["max_abs_err"],
                           record["skew"]["max_abs_err"]),
        "ms": kk["ms"],
        "plain_ms": kk["plain_ms"], "bound_ms": kk["bound_ms"],
        "bound_by": kk["bound_by"], "library_ms": kk["library_ms"]},
        # the same kernel at each shape a path launches it at, with that
        # shape's launches beside its own times (phase_matvec, one process
        # alone on the card): w8a-like's A and A^T on the d-space paths,
        # the row band of rcv1-like's K on the mesh path
        matvec_record("matvec_w8a_A_49749x300", "w8a_A",
                      by_shape.get(w8a["w8a_A"], 0),
                      mv["cases"]["49749x300_float32"]["max_abs_err"]),
        matvec_record("matvec_w8a_At_300x49749", "w8a_At",
                      by_shape.get(w8a["w8a_At"], 0),
                      mv["cases"]["300x49749_float32"]["max_abs_err"]),
        matvec_record("matvec_band_5120x20480", "5120x20480_float32",
                      record["mesh"]["band_launches"],
                      record["mesh"]["band_max_abs_err"])]}
    for rec in kernels["kernels"]:
        if rec["launches"] <= 0:
            raise RuntimeError(f"{rec['name']}: no launch on its path")
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            # numpy scalars and the like go as text
            json.dump(dict(record, **kernels), fh, indent=1, default=str)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
