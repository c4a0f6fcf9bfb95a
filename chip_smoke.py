#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--out FILE.json]

Phases (each raises on failure, so the exit code is non-zero):

1. device   require CUDA; print the card's name and power limit;
2. build    compile csrc/symv.cu, csrc/matvec.cu, csrc/subproblem.cu,
            csrc/eigh.cu and csrc/fold.cu (the last three with
            --fmad=false) with nvcc, one process each, started together
            (into krylov_crn_tpu_torch/_build);
2a. fold    the fold kernel (csrc/fold.cu: sum2 and dot2 of a batch of
            rows, one launch) at the shapes the folds meet, fp32 and
            fp64, dot2 with a broadcast 1-D operand, and on inf, NaN and
            signed zeros: bit for bit its plain version (ops/math.py) on
            the CPU and on the card; 25 calls timed at (2, 20480),
            (21, 20480) and (21, 49749) beside the plain version,
            torch.sum and the bound by bytes. From here on a CUDA tensor
            that reaches the plain folds raises; each main-path phase
            records the kernel's launches (counters zeroed before it);
3. kernel   SYMV kernel against its plain PyTorch version and an fp64
            product on bitwise-symmetric random K (one tile, an odd tile
            count, n_pad = 20480): relative error below 1e-6, bitwise
            reproducible;
4. main     the rcv1-like stand-in (20242 x 47236, 1.5M nnz, fp32): device
            K build (every panel through the bf16 split, split_panels
            equal to the panel count, K bitwise symmetric), then
            GramKrylov(m=10).run_fused(it_max=48, chunk=24,
            certify=True), with f* from an m=20 run of 192 iterations on the
            same K. Requires a certified exact gap <= 1e-8 within 48
            iterations, non-increasing exact chunk-boundary values, every
            K-matvec on the card launched through the SYMV kernel (a
            replayed step counts the launches its capture made), and the
            race's steps replayed from captured CUDA graphs (graph_replays,
            printed by every race phase, at least its iterations);
4a. fused   on phase 4's K, from the race's initial state: 48 eager steps,
            each one's subproblem kernel (csrc/subproblem.cu) against its
            numpy emulation bit for bit and against its plain version
            (cuSOLVER's eigh and the Newton loop) within the CPU tests'
            tolerances; the kernel, the plain version and torch.linalg.eigh
            timed with CUDA events; one 24-step chunk eager against its
            graph replays bit for bit (the process's graph cache emptied
            first, so the capture and its pool are measured), the replays
            inside
            torch.cuda.set_sync_debug_mode("error"); wall, device time,
            busy share, host launches and SYMV kernels per step, eager and
            replayed (torch.profiler; SYMV 11 times and the fold kernel
            24 times per replayed step);
4b. dspace_fused the d-space Krylov step (w8a-like, fp32, m=10, the 21
            line-search candidates at once) 24 steps eager against 24
            replays of the captured step, bit for bit, the replays inside
            sync debug mode "error"; every candidate's value pair against
            the one-candidate call bit for bit; replays, matvec launches
            (21 a step, = dense-branch calls) and subproblem launches (one
            a step) counted; wall, device, busy share, host launch calls
            and matvec kernels per step, eager and replayed. Then one
            GramCRN CG solve on phase 4's K from its initial state (shift
            1e-5): the per-iteration loop, eager blocks and replayed blocks
            of crn_gram.CG_BLOCK iterations, bit for bit with equal counts,
            one replay and one host read per block; wall, device, busy and
            launches per CG iteration for the loop and the replays;
4c. eigh    the dense eigh kernel (csrc/eigh.cu, a parallel Jacobi) and
            the dense-spectrum Newton (csrc/subproblem.cu eig_secular):
            each equal to its numpy emulation bit for bit at small sizes
            (eigh n = 8, 33, 70 fp32, 33 fp64, an SSCN-like 60 with empty
            rows; eig_secular m = 10, 70, 300); at n = 10, 300, 500 and
            1000 fp32, on a random symmetric and an SSCN-like matrix, the
            residual ||HQ - Q diag theta|| / ||H|| and ||Q^T Q - I|| within
            4 n eps, max |theta - theta_LAPACK| within 16 eps ||H||
            (cuSOLVER's difference printed), exact zeros counted beside
            cuSOLVER's; the kernel, cuSOLVER
            (torch.linalg.eigh) and the plain version (LAPACK on the host)
            timed beside the bound (9 n^3 flops); eig_secular at m = 10,
            300, 500 and 1000 (an SSCN-like spectrum at 500 and 1000),
            L = LS_BLOCK, against the Newton loop;
4d. ls_fused the CRN "full" step (w8a-like) and the SSCN step (rcv1-like,
            m = 500): 10 steps eager against 10 replays of the captured
            step, bit for bit, with the steps' host reads (the line-search
            flag) at most one per step plus one per further block, one
            eigh and one Newton launch per block; the SSCN panel and
            partials under sync debug mode "error"; wall, device time,
            busy share and host launch calls per step, eager and replayed;
            20-step CRN runs at line-search blocks 1, 2, 4 and 8;
5. kernel@K the kernel against plain and fp64 on the built K (they differ
            by less than 1e-6 of the fp64 product's norm), and both timed
            with CUDA events (median of 25 chained calls); symv_at (K
            through a KSlot, the entry of the cached Gram step graphs)
            against plain and against symv bit for bit, timed against it;
            repeated on phase 14's K (n_pad 20224), the other shape SYMV
            is driven at;
5a. bf16_head GramKrylov(bf16_head=True, m=10) on phase 4's K and f*,
            K_lr = K in bf16: run_fused(it_max=96, chunk=24, certify=True)
            to a certified 1e-8 gap within 96 iterations (the JAX package
            crossed at 57 with the head, 33 without), exact boundary values
            that never rise, the switch to the fp32 K (its iteration is
            printed), bf16 matvec launches at the K's shape equal to the
            head's Lanczos products on the card (> 0) and every fp32
            K-matvec through SYMV; the card's K_lr against the CPU's
            rounding of K bit for bit, one bf16 product against its plain
            version on the bf16-rounded q (relative error against fp64 of
            the same function below 1e-6, bitwise repeatable), and a step's
            device time for 10 bf16 products and the fp32 image refresh
            against 10 SYMVs; repeated on phase 14's K with it_max 48;
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
            K-matvec through the SYMV kernel; CG iterations, CG block
            replays and host reads per iteration printed, every block
            replayed and fewer host reads than CG iterations;
7. matvec   the dense matvec kernel against its plain version and an fp64
            product, fp32 and bf16 K at (20480, 20480), (20224, 20224), the
            (5120, 20480)
            row band of phase 18, w8a's (49749, 300) and (300, 49749), and
            a ragged (1003, 3333): relative error below 1e-6, bitwise
            reproducible, with its plan, shared memory and blocks per SM;
            kernel, plain and torch.mv timed with CUDA events
            (utils/profiling, each call with a cold L2) at n = 20480, on
            the band, on bf16 K at 20224 and on w8a's padded copies;
8. dense    the d-space path on the w8a-like stand-in (49749 x 300, fp32 on
            the card, dense branch): CubicKrylov(m=10) for 100 iterations
            and CubicNewton("full") for 20, every iterate's loss
            re-evaluated in fp64 on the host (CubicNewton's steps replay
            their graph: replays = iterations, the steps' host reads at
            most one per step plus one per further block). f* is the
            port's fp64
            CubicNewton("full") on the CPU, which must agree with the JAX
            package's recorded fp64 optimum within 1e-11. Requires a final
            gap <= 1e-9 for both, a loss trace that never rises by more
            than 1e-12 (fp64 re-evaluation of fp32 iterates that differ by
            rounding), every dense-branch product on the card launched
            through the matvec kernel, and every CubicKrylov step a replay
            of its captured graph (graph replays = iterations, one
            subproblem launch a step). The oracle's best fp32 value
            reading must lie within one fp32 ulp of f*; its offset is
            printed with its parts (iterate, fp32 margins, fp32 terms),
            and scaling and summing the terms may move it by 1e-9 at most;
9. sparse   CubicKrylov(m=10) on the rcv1-like stand-in (CSR branch) for 10
            iterations in fp32 on the card, twice (the two runs must agree
            bitwise), against the port's fp64 CPU run of the same 10
            iterations: the fp64-evaluated loss of the last iterate within
            1e-6 relative. The CSR products make no host read after their
            first call (sync debug mode "error": index_select,
            segment_reduce, spmv_csr), so every card step is a replay
            (20 replays, 2 captures, 22 subproblem launches), and the
            replayed run equals 10 eager steps bit for bit;
10. measure the ported tools/measure_matvec.py rows at n = 20480;
11. cli_gram the port's CLI run grid (cli.run_grid) on the rcv1-like stand-in
            at full width, fp32 on the card: GramCRN (tolerance 1e-8), SSCN
            m=500 and GramKrylov run_fused, 12 iterations each. Requires
            GramCRN's certified exact gap (against phase 4's f*) <= 1e-8
            within 12 iterations, exact values that never increase, and
            every K-matvec on the card launched through the SYMV kernel,
            and GramCRN's CG in replayed blocks (fewer host reads than CG
            iterations); prints GramCRN's seconds, CG iterations, block
            replays, host reads and rollbacks per iteration, and SSCN's gap beside the JAX
            package's m=500 curve (printed, not gated: other coordinates);
12. sscn    SSCN m=500 on rcv1-like (CSR data, column panels) for 20
            iterations: fp32 on the card twice and fp64 on the CPU, one
            generator seed. The card runs must agree bitwise, replay 40
            steps with at most one host read per step plus one per
            further block, and the fp64 loss of the last card iterate must
            be within 1e-6 relative of the CPU run's;
13. cli_dense cli.run_grid on the w8a-like stand-in (d-space path): CRN
            "full", SSCN m=10 and CubicKrylov, 20 iterations. Requires every
            dense-branch product on the card launched through the matvec
            kernel, every CubicKrylov, CRN and SSCN step replayed, and
            CRN's final fp64 gap <= 1e-9 against the JAX package's
            optimum;
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
            best fp32 value reading within one fp32 ulp of f*, the
            products through their kernels, and the CRN and SSCN steps
            replayed (a warm-up step each beside the iterations);
16. skew    the K build under heavy column skew: the power-law problem at
            rcv1's shape (957,861 nnz, 22 panels, the first holding 722,633;
            skewed by the JAX package's rule nblk * cap > 4 * nnz). K
            against host A A^T on 4,096 sampled rows (rel <= 1e-5), bitwise
            symmetric, every panel through the split, and one SYMV on it
            against fp64 and against its plain version;
16a. splitk the port of tools/measure_splitk.py
            (krylov_crn_tpu_torch/tools/measure_splitk.py): on rcv1-like's
            first 4,096 rows the split build and a direct fp32 SGEMM
            against host fp64 (the split's K-matvec error <= 1e-6 and <= 4x
            the SGEMM's); the panel step at (20480 x 2048), split against
            SGEMM, in ms and TFLOP/s beside each one's bound; the card's
            split P against its plain version (within 0.05 of the bound of
            two fp32 sums of the same exact terms in any two orders, and
            the same comparison of P rounded to bf16 beyond that); whole
            builds of rcv1-like and news20-like, every panel through the
            split.
            One JSON line; the split product is a cuBLAS call, not a kernel
            record;
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
            (fp32, m=10, chunk 24, it_max 48, certify; each rank's whole K
            build through the split, the bands gathered afterwards into a
            bitwise-symmetric K): a certified 1e-8
            crossing against phase 4's f*, boundary values non-increasing,
            exact values within 1e-5 relative of phase 4's single-device
            race and at the same iterations (past 1e-5, which rounding
            order alone decides, a certified final gap within 1e-8
            instead: ROADMAP C.4); m + 1 all-gathers per step
            (budget m + 2) and no all-reduce; every band product went
            through the matvec kernel (launches == band calls == all-gathers
            on every rank); no graph replay (gloo's collectives cannot be
            captured: the sharded step runs eagerly, still through the
            subproblem kernel); each rank's band kernel against its plain
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
            NCCL group;
19. bench   the port's bench as a user runs it, ``python -m
            krylov_crn_tpu_torch.bench --reps 2`` in a process of its own
            (600 s limit): bench.py's races on news20-like and rcv1-like
            (K build, m=10 race, m=20 f* run, two attempts each), the
            torch.mv roofline, SYMV and the HVP throughput. Its JSON line
            must hold every key of bench.py's; both races a certified 1e-8
            gap within 48 iterations, SYMV launches equal to the K-matvecs
            on the card (> 0), every build panel through the split (the
            bench raises on a K that is not bitwise symmetric); vs_baseline null (no reference leg), the
            card's line; its symv_ms within 10% of phase kernel@K's median
            at n_pad 20480.

The kernel records count the launches of every phase that drives a
solver (each phase resets the counts just before and reads them just
after; phase bench's process counts its own, per race). The subproblem
kernel's record, ``tridiag_secular``, counts the Gram races of phases
main, bf16_head, cli_gram, news20 and figure2 and the d-space Krylov
steps of phases dense, sparse, cli_dense and figure2 (one launch per
step: a capture's eager warm-up step, a replay, or an eager CSR step). The matvec
kernel has a record for each shape a path launches it at, its launches
there beside its times at that shape: w8a-like's A
(49749, 300) and A^T (300, 49749) on the d-space paths (counted by shape,
matvec.shape_launches), the mesh path's band (5120, 20480), and the bf16
K of the head at (20480, 20480) and (20224, 20224). The records
``sym_eigh`` and ``eig_secular`` count the CRN "full" and SSCN steps of
phases dense, cli_gram, sscn, cli_dense and figure2, timed at CRN full's
n = 300 (w8a-like) and m = 300, L = 4. Prints
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
# the bf16 head's race limits: the JAX package crossed rcv1-like's 1e-8 at
# iteration 57 with the head (33 without); news20-like keeps the fp32 limit
BF16_HEAD_ITS = {"rcv1-like": 96, "news20-like": 48}


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
    from krylov_crn_tpu_torch.ops import eigh as eigh_mod
    from krylov_crn_tpu_torch.ops import math as math_mod
    from krylov_crn_tpu_torch.ops import matvec as matvec_mod
    from krylov_crn_tpu_torch.ops import subproblem as subproblem_mod
    from krylov_crn_tpu_torch.ops import symv as symv_mod

    t0 = time.perf_counter()
    libs = (symv_mod, matvec_mod, subproblem_mod, eigh_mod, math_mod)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source
        for f in [pool.submit(mod._library) for mod in libs]:
            f.result()
    s = time.perf_counter() - t0
    nv = {k: round(v, 3) for k, v in _kernels.last_build_seconds.items()}
    print(f"build: symv.cu, matvec.cu, subproblem.cu, eigh.cu and fold.cu "
          f"in {s:.3f} s (nvcc {nv}; subproblem.cu, eigh.cu and fold.cu "
          f"with {_kernels.KERNEL_FLAGS['subproblem']})")
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


# the shapes the folds meet: one value; a row short of the lanes; rep_dot's
# two rows (news20-like's and rcv1-like's n_pad); the Gram step's 21
# candidates; the d-space step's 21 candidates at w8a's n
FOLD_SHAPES = ((1, 1), (3, 1023), (2, 20224), (2, 20480), (21, 20480),
               (21, 49749))
FOLD_TIMED = ((2, 20480), (21, 20480), (21, 49749))


def _fold_operands(shape, dtype, seed):
    """(x, y): x one row of n, y ``shape``; mixed signs over ten decades."""
    import torch

    rng = np.random.default_rng(seed)
    mags = lambda s: rng.standard_normal(s) * 10.0 ** rng.uniform(-5, 5, s)
    return (torch.from_numpy(mags(shape[-1])).to(dtype),
            torch.from_numpy(mags(shape)).to(dtype))


def _fold_special(dtype, kind):
    """(x, y) of (4, 3000) with rows of -0 (``signed_zero``), or an inf or
    NaN among finite values and inf - inf in one row."""
    x, y = _fold_operands((4, 3000), dtype, 17)
    x = x.expand(4, 3000).clone()
    if kind == "signed_zero":
        x[:2] = -0.0
        x[2, :1024] = -0.0
        y[0], y[1] = -0.0, 0.0
    else:
        v = float("inf") if kind == "inf" else float("nan")
        x[0, 5], x[1, 1500], y[2, 2999] = v, -v, v
        x[3, 7], x[3, 2048] = v, -v
    return x, y


def phase_fold(dev):
    """The fold kernel against its plain version, and its times (see the
    module's docstring, phase 2a)."""
    import torch

    from krylov_crn_tpu_torch.ops import math as tm
    from krylov_crn_tpu_torch.utils.profiling import (
        HBM_BYTES_PER_S,
        alternating_ms,
        device_time_per_call,
    )

    launches0 = tm.fold.launches
    max_abs_err = 0.0
    cases = []
    for dt in (torch.float32, torch.float64):
        for i, shape in enumerate(FOLD_SHAPES):
            cases.append((f"{shape} {dt}", *_fold_operands(shape, dt, i)))
        for kind in ("inf", "nan", "signed_zero"):
            cases.append((f"{kind} {dt}", *_fold_special(dt, kind)))
    for tag, x, y in cases:
        xc, yc = x.to(dev), y.to(dev)
        got = tm.sum2(yc) + tm.dot2(xc, yc)
        on_card = tm._lane_fold(yc) + tm.dot2_plain(xc, yc)
        on_cpu = tm._lane_fold(y) + tm.dot2_plain(x, y)
        torch.cuda.synchronize()
        for name, g, c, h in zip(("sum2 hi", "sum2 lo", "dot2 hi",
                                  "dot2 lo"), got, on_card, on_cpu):
            g = g.cpu().numpy()
            if not (_same_bits(g, h.numpy())
                    and _same_bits(g, c.cpu().numpy())):
                raise RuntimeError(f"fold: {tag}: the kernel's {name} "
                                   f"differs from its plain version")
            both = np.isfinite(g) & np.isfinite(h.numpy())
            if both.any():
                max_abs_err = max(max_abs_err, float(np.abs(
                    g[both].astype(np.float64)
                    - h.numpy()[both].astype(np.float64)).max()))
    checked = tm.fold.launches - launches0
    if checked != 2 * len(cases):
        raise RuntimeError(f"fold: {checked} launches for {len(cases)} "
                           f"cases of sum2 and dot2")
    print(f"fold: sum2 and dot2 on {len(cases)} cases (shapes "
          f"{FOLD_SHAPES} and inf, NaN, signed zeros; fp32 and fp64; dot2 "
          f"with a broadcast 1-D operand): bit for bit the plain version on "
          f"the CPU and on the card, one launch a call")

    out = {"cases": len(cases), "max_abs_err": max_abs_err, "times": {}}
    for shape in FOLD_TIMED:
        x, y = (t.to(dev) for t in _fold_operands(shape, torch.float32, 0))
        rows, n = shape
        for op, kernel, plain, nbytes in (
                ("sum2", lambda v: tm.fold(v)[0],
                 lambda v: tm._lane_fold(v)[0], 4 * (rows * n + 2 * rows)),
                ("dot2", lambda v: tm.fold(x, v)[0],
                 lambda v: tm.dot2_plain(x, v)[0],
                 4 * (n + rows * n + 2 * rows))):
            kms, pms = alternating_ms(kernel, plain, y)
            lib_ms = device_time_per_call(lambda v: torch.sum(v, -1), y)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            out["times"][f"{op} {rows}x{n}"] = dict(
                ms=min(kms), ms_runs=kms, plain_ms=min(pms), plain_ms_runs=pms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes",
                nbytes=nbytes)
            print(f"fold: {op} ({rows}, {n}) fp32: kernel {kms} ms, plain "
                  f"{pms} ms, torch.sum {lib_ms:.4f} ms, bound {bound_ms:.3e}"
                  f" ms by bytes ({nbytes} bytes)")
    return out


def _plain_folds_refuse_the_card():
    """From here on a CUDA tensor that reaches the plain folds raises:
    every fold on the card is the kernel's."""
    from krylov_crn_tpu_torch.ops import math as tm

    def guarded(x, *args, _plain=tm._lane_fold, **kw):
        if x.is_cuda:
            raise RuntimeError("chip_smoke: a CUDA tensor reached the plain "
                               "_lane_fold")
        return _plain(x, *args, **kw)

    tm._lane_fold = guarded


def _certified_crossing(tag, trace, f_star, it_max):
    """The certified gaps of a fused Gram race against ``f_star``: raises
    unless the gap falls to GAP within ``it_max`` iterations, the exact
    boundary values never rise and the loss trace is finite. Returns
    (exact iterations, gaps, crossing iteration, its time into the race,
    boundary values)."""
    its = list(trace.metrics["exact_its"])
    gaps = [float(v) - f_star for v in trace.metrics["exact_fs"]]
    cross = next((it for it, g in zip(its, gaps) if g <= GAP), None)
    cross_t = dict(zip(trace.its, trace.ts)).get(cross)
    bfs = list(trace.metrics["boundary_fs"])
    if cross is None or cross > it_max:
        raise RuntimeError(f"{tag}: no certified {GAP} gap within {it_max} "
                           f"iterations (best {min(gaps):.3e})")
    if any(b2 > b1 for b1, b2 in zip(bfs, bfs[1:])):
        raise RuntimeError(f"{tag}: exact boundary values increased: {bfs}")
    lv = np.asarray(trace.loss_vals)
    if lv.shape != (len(trace.its),) or not np.all(np.isfinite(lv)):
        raise RuntimeError(f"{tag}: bad loss trace: shape {lv.shape}")
    return its, gaps, cross, cross_t, bfs


def _panel_count(A):
    """The panels of A's device K build (empty columns compacted)."""
    from krylov_crn_tpu_torch.ops.gram import _pack_flat_panels, pad_rows

    return int(_pack_flat_panels(A, pad_rows(A.shape[0]), np.float32)[-1])


def _split_build_ok(tag, A, K):
    """After one fp32 device build of A's K (counts reset just before):
    every panel's bf16 products ran on the card (``split_panels``, the
    count of ``syrk_split_P``'s card branch, equal to the panel count)
    and K is bitwise symmetric."""
    from krylov_crn_tpu_torch.ops.gram import build_K_device, syrk_split_P

    rec = dict(panels=build_K_device.panels,
               split_panels=syrk_split_P.cuda_calls,
               bitwise_symmetric=bool(K.equal(K.T)))
    return _split_rec_ok(tag, rec, _panel_count(A))


def _split_rec_ok(tag, rec, want):
    """Raises unless ``rec`` (panels, split_panels, bitwise_symmetric)
    shows ``want`` panels, all through the split, and a bitwise-symmetric
    K."""
    print(f"{tag}: K build panels {rec['panels']}, through the split "
          f"{rec['split_panels']} (want {want}); bitwise symmetric "
          f"{rec['bitwise_symmetric']}")
    if not rec["split_panels"] == rec["panels"] == want:
        raise RuntimeError(f"{tag}: fp32 K panels bypassed the split: {rec}")
    if not rec["bitwise_symmetric"]:
        raise RuntimeError(f"{tag}: K is not bitwise symmetric")
    return dict(rec, want=want)


def _gram_race(tag, name, dev):
    """The Gram-space main path on the stand-in ``name``: device K build,
    the m=10 race with certification, f* from an m=20 run on the same K,
    and the gates of phases ``main`` and ``news20``."""
    import torch

    from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import (
        build_K_device,
        k_matvec,
        syrk_split_P,
    )
    from krylov_crn_tpu_torch.ops.symv import symv

    t0 = time.perf_counter()
    A, b = synthetic_logreg(name, seed=0)
    gen_s = time.perf_counter() - t0
    x0 = np.ones(A.shape[1]) * 0.5
    print(f"{tag}: {name} {A.shape} nnz {A.nnz} generated in {gen_s:.2f} s")
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=dev, label="gram")

    _reset_counts()
    build_K_device.panels = syrk_split_P.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg.init_run(x0, 42)
    alg.initialized = True
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k_build = _split_build_ok(tag, A, alg.gd.K)
    t0 = time.perf_counter()
    trace = alg.run_fused(x0, it_max=48, chunk=24, certify=True)
    race_s = time.perf_counter() - t0
    race = _counts()
    race_launches = race["symv"]
    t0 = time.perf_counter()
    ref = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=20, tolerance=0,
                     device=dev, label="gram-fstar", gram_data=alg.gd)
    ref.run_fused(x0, it_max=192, chunk=32)
    fstar_s = time.perf_counter() - t0
    launches, calls = symv.launches, k_matvec.cuda_calls
    cnt = _counts()
    del ref

    f_star = float(loss.f_opt)
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    print(f"{tag}: K build {build_s:.3f} s (n_pad {alg.gd.n_padded}), race "
          f"{race_s:.3f} s for {alg.it} iterations, f* run {fstar_s:.3f} s")
    print(f"{tag}: symv launches {launches} (race {race_launches}), "
          f"k_matvec calls on the card {calls}; graph replays "
          f"{cnt['graph_replays']} (race {race['graph_replays']}, captures "
          f"{cnt['graph_captures']}); subproblem kernel launches "
          f"{cnt['subproblem']}")
    if not (launches == calls and race_launches > 0):
        raise RuntimeError(f"{tag}: K-matvecs bypassed the kernel: "
                           f"{launches} launches vs {calls} calls")
    if not (race["graph_replays"] >= alg.it > 0 and cnt["subproblem"]
            >= cnt["graph_replays"]):
        raise RuntimeError(f"{tag}: the race did not replay its steps: "
                           f"{race['graph_replays']} replays for {alg.it} "
                           f"iterations, {cnt['subproblem']} subproblem "
                           "launches")
    its, gaps, cross, cross_t, bfs = _certified_crossing(tag, trace, f_star,
                                                         48)
    print(f"{tag}: f* {f_star:.17g}; crossing at iteration {cross} "
          f"(t {cross_t:.3f} s into the race); "
          f"final certified gap {gaps[-1]:.3e}, best {min(gaps):.3e}")
    print(f"{tag}: boundary exact values {bfs}; rollbacks "
          f"{trace.metrics['rollback_its']}; chunks "
          f"{len(bfs) + len(trace.metrics['rollback_its'])}")
    return alg, dict(gen_s=gen_s, build_s=build_s, k_build=k_build,
                     race_s=race_s,
                     fstar_s=fstar_s, iterations=alg.it, crossing_it=cross,
                     crossing_t=cross_t, f_star=f_star,
                     final_gap=gaps[-1], best_gap=min(gaps),
                     exact_its=its, exact_fs=fs, boundary_fs=bfs,
                     launches=launches,
                     race_launches=race_launches, kmatvec_calls=calls,
                     graph_replays=cnt["graph_replays"],
                     race_graph_replays=race["graph_replays"],
                     graph_captures=cnt["graph_captures"],
                     subproblem_launches=cnt["subproblem"],
                     fold_launches=cnt["fold"])


def phase_main(dev):
    return _gram_race("main", "rcv1-like", dev)


FUSED_STEPS = 48  # the race's iterations
FUSED_CHUNK = 24  # the race's chunk
# the CPU tests' tolerances (tests/test_torch_subproblem_kernel.py) for the
# kernel against its plain version: theta within 16 eps ||T||_2, lambda
# within 1e-5 relative or the Newton's absolute stop, Newton counts within
# 8 unless one side runs to it_max, the step S within lambda's tolerance
# plus lambda's and theta's absolute errors over min |theta + lambda|
SUB_THETA_EPS = 16
SUB_LAM_REL = 1e-5
SUB_ITS_GAP = 8


def _same_bits(a, b):
    """a and b hold the same bits (NaN where the other is NaN, whatever
    its payload)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind != "f":
        return bool(np.array_equal(a, b))
    na, nb = np.isnan(a), np.isnan(b)
    u = {4: np.uint32, 8: np.uint64}[a.itemsize]
    return bool(np.array_equal(na, nb)
                and np.array_equal(a[~na].view(u), b[~nb].view(u)))


def _subproblem_close(host, got, want, xtol, it_max):
    """The kernel's (theta, Q, lams, its) ``got`` against the plain
    version's ``want`` on the inputs ``host`` (numpy), at the CPU tests'
    tolerances; returns the worst (theta in eps ||T||, lambda relative,
    Newton count gap, S relative) or raises."""
    alphas, betas, g_norm = host[0], host[1], float(host[2])
    dt = alphas.dtype
    eps = float(np.finfo(dt).eps)
    T = (np.diag(alphas.astype(np.float64))
         + np.diag(betas.astype(np.float64), 1)
         + np.diag(betas.astype(np.float64), -1))
    th_bound = SUB_THETA_EPS * eps * max(np.linalg.norm(T, 2), 1e-300)
    theta, Q, lam, its = (np.asarray(v) for v in got)
    theta_p, Q_p, lam_p, its_p = (np.asarray(v) for v in want)
    th_err = float(np.max(np.abs(theta.astype(np.float64) - theta_p)))
    lam_tol = SUB_LAM_REL if dt == np.float32 else 1e-10
    atol = xtol if dt == np.float32 else 0.0
    fin = np.isfinite(lam) & np.isfinite(lam_p)
    pole = -float(theta_p[0])
    for side in (lam, lam_p):  # a Newton iterate that lands on the pole
        off = ~fin & np.isfinite(side)
        if not np.all(np.abs(side[off] - pole) <= lam_tol * abs(pole)):
            raise RuntimeError(f"subproblem: lambda {side[off]} is NaN on "
                               f"one side and off the pole {pole}")
    lam_err = np.abs(lam[fin].astype(np.float64) - lam_p[fin])
    lam_ok = lam_err <= lam_tol * np.abs(lam_p[fin]) + atol
    gap = np.abs(its - its_p)[fin]
    capped = ((its == it_max) | (its_p == it_max))[fin]

    def step(th, q, lm):
        th, q, lm = (np.asarray(v, np.float64) for v in (th, q, lm))
        c = g_norm * q[0, :]
        den = th[None, :] + lm[:, None]
        u = np.where(c != 0, -c / np.where(c != 0, den, 1.0), 0.0)
        return u @ q.T

    S, S_p = step(theta, Q, lam[fin]), step(theta_p, Q_p, lam_p[fin])
    near = np.min(np.abs(theta_p[None, :].astype(np.float64)
                         + lam_p[fin][:, None]), axis=1, initial=np.inf)
    s_tol = lam_tol + (lam_tol * np.abs(lam_p[fin]) + atol + th_bound) / near
    s_err = np.max(np.abs(S - S_p), axis=1, initial=0.0)
    s_scale = max(float(np.abs(S_p).max(initial=0.0)), 1e-300)
    worst = dict(theta=th_err / (eps * max(np.linalg.norm(T, 2), 1e-300)),
                 lam=float(np.max(lam_err / np.maximum(np.abs(lam_p[fin]),
                                                      1e-300), initial=0.0)),
                 its=int(np.max(gap[~capped], initial=0)),
                 step=float(np.max(s_err / s_scale, initial=0.0)),
                 abs_err=max(th_err, float(np.max(lam_err, initial=0.0))))
    if not (th_err <= th_bound and lam_ok.all()
            and (gap[~capped] <= SUB_ITS_GAP).all()
            and (s_err <= s_tol * s_scale).all()):
        raise RuntimeError(f"subproblem: kernel against plain beyond the "
                           f"tolerances: {worst}")
    return worst


# throwaway kernels (torch.cuda._sleep's spin_kernel) that open every
# traced window and are left out of its counts: once the process has run
# CUDA graphs, the first kernel records of a trace are lost (an eager
# d-space window after phase fused lost its first five, a matvec among
# them; a clean process loses none)
PROFILE_PAD = 64


def _profile_window(fn, steps, kernel):
    """One traced run of ``fn()``: its counts per step (``_profile_steps``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    device_us = kernels = named = folds = 0
    launches = -PROFILE_PAD
    for ev in prof.key_averages():
        if "spin_kernel" in ev.key:  # the pad
            continue
        if ev.device_type == DeviceType.CUDA:  # a kernel, copy or fill
            device_us += getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
            kernels += ev.count
            if kernel in ev.key:
                named += ev.count
            if "fold_kernel" in ev.key:
                folds += ev.count
        elif ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaGraphLaunch", "cudaMemcpyAsync",
                                "cudaMemsetAsync")):
            launches += ev.count
    return dict(device_ms=device_us / 1e3 / steps, kernels=kernels / steps,
                named=named / steps, folds=folds / steps,
                launches=launches / steps)


def _profile_steps(fn, steps, kernel="symv_upper_tiles"):
    """Per step of ``fn()`` (``steps`` steps) under torch.profiler: device
    ms (every kernel, copy and fill), device kernels, kernels whose name
    holds ``kernel`` (``named``), fold kernels (``folds``) and host launch
    calls (kernels, graphs, copies, fills). Two traced runs, each after PROFILE_PAD throwaway
    kernels. The counts and ``device_ms`` are those of the window with
    more device records, because the tracer can lose a window's kernel
    records but never adds any (why it loses them is not known);
    ``device_ms_windows`` holds both windows' device ms, in run order, so
    that what the choice moved is printed beside it."""
    runs = [_profile_window(fn, steps, kernel) for _ in range(2)]
    best = max(runs, key=lambda r: r["kernels"])
    return dict(best, device_ms_windows=[r["device_ms"] for r in runs])


def phase_fused(dev, alg):
    """The Gram step without host round trips, on phase main's K (see the
    module's docstring, phase 4a)."""
    import torch

    from krylov_crn_tpu_torch import GramKrylov
    from krylov_crn_tpu_torch.ops import subproblem as sp
    from krylov_crn_tpu_torch.solvers import krylov_gram as kg
    from krylov_crn_tpu_torch.utils.profiling import (
        alternating_ms,
        device_time_per_call,
    )

    fresh = GramKrylov(loss=alg.loss, reg_coef=1e-3, subspace_dim=10,
                       tolerance=0, device=dev, label="gram-fused",
                       gram_data=alg.gd)
    fresh.init_run(alg._x0_host, 42)
    gd, st0, kw = fresh.gd, fresh.state, fresh._step_kwargs()
    xtol, it_max = kw["solver_eps"], kw["solver_it_max"]

    # ---- the kernel on the 48 eager steps' inputs ----
    seen = []
    launch = kg.tridiag_secular

    def record(*args, **k):
        out = launch(*args, **k)
        seen.append((tuple(a.clone() for a in args),
                     tuple(o.clone() for o in out)))
        return out

    kg.tridiag_secular = record
    try:
        kg.gram_krylov_multistep(gd, st0, chunk=FUSED_STEPS, use_lr=False,
                                 **kw)
    finally:
        kg.tridiag_secular = launch
    torch.cuda.synchronize()
    worst = dict(theta=0.0, lam=0.0, its=0, step=0.0, abs_err=0.0)
    rotations = newton_its = 0
    for i, (args, out) in enumerate(seen):
        host = [a.cpu().numpy() for a in args]
        got = [o.cpu().numpy() for o in out]
        emu = sp.tridiag_secular_emulated(*host, xtol=xtol, it_max=it_max)
        rotations += sp.tridiag_secular_emulated.rotations
        newton_its += int(got[3].sum())
        for name, g, e in zip(("theta", "Q", "lams", "its"), got, emu):
            if not _same_bits(g, e):
                raise RuntimeError(f"fused: step {i + 1}: the kernel's "
                                   f"{name} differs from its emulation")
        plain = [o.cpu().numpy() for o in sp.tridiag_secular_plain(
            *args, xtol=xtol, it_max=it_max)]
        for k2, v in _subproblem_close(host, got, plain, xtol,
                                       it_max).items():
            worst[k2] = max(worst[k2], v)
    m, L = seen[0][0][0].numel(), seen[0][0][3].numel()
    print(f"fused: subproblem kernel on {len(seen)} steps' inputs (m {m}, "
          f"L {L}): bit for bit its emulation; against plain (cuSOLVER "
          f"eigh + Newton loop) worst theta {worst['theta']:.2f} eps "
          f"||T||, lambda {worst['lam']:.3e} relative, Newton count gap "
          f"{worst['its']}, step {worst['step']:.3e} relative; "
          f"{newton_its} Newton steps, {rotations} QL rotations")

    # times on the last step's inputs: kernel, plain, eigh alone
    args = seen[-1][0]
    T = (torch.diag(args[0]) + torch.diag(args[1], -1)
         + torch.diag(args[1], 1))
    kms, pms = alternating_ms(
        lambda v: sp.tridiag_secular(*args, xtol=xtol, it_max=it_max)[2],
        lambda v: sp.tridiag_secular_plain(*args, xtol=xtol,
                                           it_max=it_max)[2], args[3])
    eigh_ms = device_time_per_call(lambda v: torch.linalg.eigh(T)[0],
                                   args[0])
    one = torch.zeros(1, device=dev)
    launch_ms = device_time_per_call(lambda v: v + 1.0, one)
    steps_its = int(seen[-1][1][3].sum())
    # bytes: the inputs once, theta, Q, lams and its once; operations: the
    # last step's QL rotations (~20 scalar + 6 m for its row updates),
    # its Newton steps (~6 m + 12 each), the sort's m^2 comparisons
    sp.tridiag_secular_emulated(*[a.cpu().numpy() for a in args],
                                xtol=xtol, it_max=it_max)
    isz = args[0].element_size()
    nbytes = isz * (m + (m - 1) + 1 + L + 1 + m + m * m + L) + 8 * L
    flops = (sp.tridiag_secular_emulated.rotations * (20 + 6 * m)
             + steps_its * (6 * m + 12) + m * m)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"fused: subproblem kernel {kms} ms, plain {pms} ms, "
          f"torch.linalg.eigh alone {eigh_ms:.4f} ms, one small kernel "
          f"{launch_ms:.4f} ms; bound {bound_ms:.3e} ms by {bound_by} "
          f"({nbytes} bytes, {flops} operations)")

    # ---- one chunk: eager against replayed ----
    # phase main's race filled the process's cache under this key: empty
    # it, so that what follows is a capture and its pool is measured
    kg._clear_graph_caches()
    graphs = fresh._step_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    entry = graphs.graph(gd, st0, kw, False, True, FUSED_CHUNK)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_mb = (torch.cuda.memory_reserved(dev) - reserved) / 1e6
    eager, e_outs = kg.gram_krylov_multistep(gd, st0, chunk=FUSED_CHUNK,
                                             stack_reps=True, use_lr=False,
                                             **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed, r_outs = graphs.run(entry, st0, FUSED_CHUNK, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the first launch of a new graph (its upload included), per step
    first_replay_ms = (time.perf_counter() - t0) * 1e3 / FUSED_CHUNK
    flat = lambda o: [o[0][0], o[0][1], *o[1:4], *o[4]]
    names = ["value", "value_lo", "grad_norm", "diff_norm", "solver_it",
             "gamma", "zeta"]
    differ = [f for f in kg.GramKrylovState._fields
              if not torch.equal(getattr(replayed, f), getattr(eager, f))]
    differ += [f"rows {n}" for n, a, b in zip(names, flat(r_outs),
                                              flat(e_outs))
               if not torch.equal(a, b)]
    print(f"fused: capture {capture_s:.3f} s (warm-up step included), graph "
          f"pool and static buffers {pool_mb:.1f} MB; a {FUSED_CHUNK}-step "
          f"chunk replayed inside sync debug mode 'error' against eager: "
          f"{'bit for bit' if not differ else f'differs in {differ}'}")
    if differ:
        raise RuntimeError(f"fused: the replayed chunk differs from the "
                           f"eager one in {differ}")

    # ---- wall, device, busy share and launches per step ----
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    replay = lambda: graphs.run(entry, st0, FUSED_CHUNK, True)
    eager_chunk = lambda: kg.gram_krylov_multistep(
        gd, st0, chunk=FUSED_CHUNK, stack_reps=True, use_lr=False, **kw)
    eager_4 = lambda: kg.gram_krylov_multistep(
        gd, st0, chunk=4, stack_reps=True, use_lr=False, **kw)
    walls = {"eager": [], "replayed": []}
    for name in ("replayed", "eager", "eager", "replayed"):
        fn = replay if name == "replayed" else eager_chunk
        walls[name].append(wall(fn) / FUSED_CHUNK)
    prof = {"replayed": _profile_steps(replay, FUSED_CHUNK),
            "eager": _profile_steps(eager_4, 4)}
    out = dict(seen=len(seen), worst=worst, newton_its=newton_its,
               rotations=rotations, ms=min(kms), ms_runs=kms,
               plain_ms=min(pms), plain_ms_runs=pms, eigh_ms=eigh_ms,
               launch_ms=launch_ms, bound_ms=bound_ms, bound_by=bound_by,
               capture_s=capture_s, pool_mb=pool_mb,
               first_replay_ms=first_replay_ms)
    for name in ("eager", "replayed"):
        p = prof[name]
        w = min(walls[name])
        out[name] = dict(p, wall_ms=w, wall_ms_runs=walls[name],
                         busy=p["device_ms"] / w)
        print(f"fused: {name} step: wall {walls[name]} ms, device "
              f"{p['device_ms']:.3f} ms (windows "
              f"{p['device_ms_windows']}), busy {p['device_ms'] / w:.1%}, "
              f"host launches {p['launches']:.1f}, device kernels "
              f"{p['kernels']:.1f}, symv_upper {p['named']:.1f}, fold "
              f"{p['folds']:.1f}")
    print(f"fused: the new graph's first chunk {first_replay_ms:.3f} ms a "
          f"step (its first launch), later chunks {walls['replayed']} ms")
    if prof["replayed"]["named"] != 11 or prof["eager"]["named"] != 11:
        raise RuntimeError(f"fused: {prof['replayed']['named']} SYMV "
                           f"kernels per replayed step, "
                           f"{prof['eager']['named']} per eager step (want "
                           "11)")
    if prof["replayed"]["folds"] != 24 or prof["eager"]["folds"] != 24:
        raise RuntimeError(f"fused: {prof['replayed']['folds']} / "
                           f"{prof['eager']['folds']} fold kernels per "
                           "replayed / eager step (want 24)")
    del fresh, graphs, entry
    torch.cuda.empty_cache()
    return out


DSPACE_STEPS = 24  # steps of the d-space step eager against replayed


def _cg_loop(gd, matvec, b, rtol, maxiter, adt):
    """CG over reps reading its stopping flag every iteration (the loop
    the blocked solve replaced, as the JAX package's ``while_loop`` runs
    it): the reference for ``crn_gram``'s blocks. Returns (x, its)."""
    import torch

    from krylov_crn_tpu_torch.ops.gram import Rep, rep_axpy, rep_dot

    cdt = b.w.dtype
    dot = lambda u, v: rep_dot(gd, u, v, adt)
    bnorm2 = dot(b, b)
    tol2 = (rtol * rtol) * bnorm2
    z = torch.zeros(b.w.shape[0], dtype=cdt, device=b.w.device)
    x = Rep(torch.zeros((), dtype=cdt, device=b.w.device), z, z)
    r = p = b
    gamma, it = bnorm2, 0
    while it < maxiter and bool(gamma > tol2):
        Ap = matvec(p)
        alpha = (gamma / dot(p, Ap)).to(cdt)
        x = rep_axpy(x, alpha, p)
        r = rep_axpy(r, -alpha, Ap)
        gamma_new = dot(r, r)
        beta = (gamma_new / gamma).to(cdt)
        p = Rep(r.beta + beta * p.beta, r.w + beta * p.w, r.u + beta * p.u)
        gamma = gamma_new
        it += 1
    return x, it


def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_dspace_fused(dev, alg):
    """The d-space Krylov step and a GramCRN CG solve without host round
    trips (see the module's docstring, phase 4b); ``alg`` is phase main's
    GramKrylov, whose K and initial state the CG solve starts from."""
    import torch

    from krylov_crn_tpu_torch import CubicKrylov, GramCRN, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.models.logistic import (
        logreg_value_from_margins,
        value_args,
    )
    from krylov_crn_tpu_torch.ops.gram import Rep, rep_axpy
    from krylov_crn_tpu_torch.solvers import crn_gram as cg
    from krylov_crn_tpu_torch.solvers import krylov_crn as kc

    out = {}
    # ---- the d-space step on w8a-like, 24 steps eager against replayed ----
    A, b = synthetic_logreg("w8a-like", seed=0)
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    kry = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                      tolerance=0)
    kry.init_run(np.ones(A.shape[1]) * 0.5, 42)
    data, bt, st0, kw = loss.data, loss.b_t, kry.state, kry._step_kwargs()

    def steps(step, k):
        st, rows = st0, []
        for _ in range(k):
            st = step(st)
            rows.append(st)
        return rows

    eager_step = lambda st: kc.krylov_step(data, bt, st, **kw)
    graphs = kc._StepGraphs(dev)
    replay_step = lambda st: graphs.step(data, bt, st, kw)
    seen = []
    trials = kc._trials

    def record(*a, **k):
        seen.append(trials(*a, **k))
        return seen[-1]

    kc._trials = record
    try:
        eager = steps(eager_step, DSPACE_STEPS)
    finally:
        kc._trials = trials
    # every candidate's value pair against the one-candidate call
    vkw = value_args(data)
    rows_differ = sum(
        not (torch.equal(t.vhis[k], hi) and torch.equal(t.vlos[k], lo))
        for t, st in zip(seen, [st0] + eager[:-1])
        for k in range(t.vhis.shape[0])
        for hi, lo in [logreg_value_from_margins(bt, t.Axs[k], st.x,
                                                 **vkw)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay_step(st0)  # the capture (its warm-up step included) and a replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = steps(replay_step, DSPACE_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    cnt = _counts()
    differ = [(i, f) for i, (e, r) in enumerate(zip(eager, replayed), 1)
              for f in kc.KrylovState._fields
              if not torch.equal(getattr(e, f), getattr(r, f))]
    print(f"dspace_fused: w8a-like {A.shape}, m 10, L {kw['ls_max'] + 1}: "
          f"capture {capture_s:.3f} s; {DSPACE_STEPS} steps replayed inside "
          f"sync debug mode 'error' against eager: "
          f"{'bit for bit' if not differ else f'differ at {differ[:6]}'}; "
          f"candidate value rows unlike the one-candidate call {rows_differ}"
          f" of {sum(t.vhis.shape[0] for t in seen)}; replays "
          f"{cnt['krylov_replays']}, matvec launches {cnt['matvec']} = "
          f"dense-branch calls {cnt['dense_calls']}, subproblem launches "
          f"{cnt['subproblem']}; solver_it {int(replayed[-1].solver_it)}")
    if differ:
        raise RuntimeError(f"dspace_fused: replayed steps differ from the "
                           f"eager ones: {differ[:6]}")
    if rows_differ:
        raise RuntimeError(f"dspace_fused: {rows_differ} candidate values "
                           "differ from the one-candidate call")
    if not (cnt["krylov_replays"] == DSPACE_STEPS
            and cnt["matvec"] == cnt["dense_calls"] == 21 * DSPACE_STEPS
            and cnt["subproblem"] == DSPACE_STEPS):
        raise RuntimeError(f"dspace_fused: counts {cnt}")
    walls = {"eager": [], "replayed": []}
    for name in ("replayed", "eager", "eager", "replayed"):
        step = replay_step if name == "replayed" else eager_step
        walls[name].append(_wall_ms(lambda: steps(step, DSPACE_STEPS))
                           / DSPACE_STEPS)
    prof = {"replayed": _profile_steps(
                lambda: steps(replay_step, DSPACE_STEPS), DSPACE_STEPS,
                "matvec_stream"),
            "eager": _profile_steps(lambda: steps(eager_step, 4), 4,
                                    "matvec_stream")}
    for name in ("eager", "replayed"):
        p, w = prof[name], min(walls[name])
        out[name] = dict(p, wall_ms=w, wall_ms_runs=walls[name],
                         busy=p["device_ms"] / w)
        print(f"dspace_fused: {name} step: wall {walls[name]} ms, device "
              f"{p['device_ms']:.3f} ms (windows "
              f"{p['device_ms_windows']}), busy {p['device_ms'] / w:.1%}, "
              f"host launches {p['launches']:.1f}, device kernels "
              f"{p['kernels']:.1f}, matvec_stream {p['named']:.1f}, fold "
              f"{p['folds']:.1f}")
    if prof["replayed"]["named"] != 21 or prof["eager"]["named"] != 21:
        raise RuntimeError(f"dspace_fused: {prof['replayed']['named']} / "
                           f"{prof['eager']['named']} matvec kernels per "
                           "replayed / eager step (want 21)")
    out.update(capture_s=capture_s, steps=DSPACE_STEPS,
               solver_it=int(replayed[-1].solver_it))
    del graphs, eager, replayed, seen

    # ---- one GramCRN CG solve on rcv1-like: blocks against the loop ----
    crn = GramCRN(loss=alg.loss, reg_coef=1e-3, tolerance=0, device=dev,
                  gram_data=alg.gd)
    crn.init_run(alg._x0_host, 42)
    gd, l2, adt = crn.gd, crn.loss.l2, torch.float32
    g, _, D, _, _ = cg._grad_probe(gd, crn.state, l2, adt)
    rhs = Rep(-g.beta, -g.w, -g.u)
    # a shift GramCRN's Newton reaches near the optimum (72 iterations in
    # fp32 on the CPU; 0.1, the first Newton's, takes 4)
    lam_c = torch.full((), 1e-5, dtype=adt, device=dev)
    hop = cg._hop(gd, D, l2)
    mv = lambda v: rep_axpy(hop(v), lam_c, v)
    eps, maxiter = crn.solver_eps, crn.cg_maxiter
    loop = lambda: _cg_loop(gd, mv, rhs, eps, maxiter, adt)
    cgg = cg._CGGraphs(dev)
    blocks = lambda: cgg.solve(gd, D, rhs, lam_c, l2, eps, maxiter, adt)
    s_loop, it_loop = loop()
    s_eager, it_eager = cg.cg_rep(gd, mv, rhs, eps, maxiter, adt)
    blocks()  # the capture
    reads0, replays0 = cg.host_read.count, cg.cg_rep.block_replays
    s_blk, it_blk = blocks()
    reads = cg.host_read.count - reads0
    replays = cg.cg_rep.block_replays - replays0
    same = lambda u, v: all(torch.equal(a, c) for a, c in zip(u, v))
    want_blocks = -(-it_loop // cg.CG_BLOCK)
    print(f"cg_blocks: rcv1-like CG solve (lam 1e-5, rtol {eps}): loop "
          f"{it_loop} iterations, eager blocks {it_eager}, replayed blocks "
          f"{it_blk}; bit for bit: eager {same(s_eager, s_loop)}, replayed "
          f"{same(s_blk, s_loop)}; {replays} block replays, {reads} host "
          f"reads (block {cg.CG_BLOCK})")
    if not (it_loop == it_eager == it_blk and same(s_eager, s_loop)
            and same(s_blk, s_loop)):
        raise RuntimeError("cg_blocks: the blocked solve differs from the "
                           "loop")
    if not (replays == reads == want_blocks):
        raise RuntimeError(f"cg_blocks: {replays} replays and {reads} reads "
                           f"for {want_blocks} blocks")
    cwalls = {"loop": [], "replayed": []}
    for name in ("replayed", "loop", "loop", "replayed"):
        cwalls[name].append(_wall_ms(blocks if name == "replayed" else loop)
                            / it_loop)
    cprof = {"replayed": _profile_steps(blocks, it_loop),
             "loop": _profile_steps(loop, it_loop)}
    out["cg"] = dict(iterations=it_loop, block=cg.CG_BLOCK, replays=replays,
                     host_reads=reads)
    for name in ("loop", "replayed"):
        p, w = cprof[name], min(cwalls[name])
        out["cg"][name] = dict(p, wall_ms=w, wall_ms_runs=cwalls[name],
                               busy=p["device_ms"] / w)
        print(f"cg_blocks: {name}, per CG iteration: wall {cwalls[name]} "
              f"ms, device {p['device_ms']:.3f} ms (windows "
              f"{p['device_ms_windows']}), busy "
              f"{p['device_ms'] / w:.1%}, host launches "
              f"{p['launches']:.2f}, device kernels {p['kernels']:.1f}, "
              f"symv_upper {p['named']:.2f}")
    del cgg, crn
    torch.cuda.empty_cache()
    return out


# the eigh's and eig_secular's sizes on the main path: SSCN m=10 (cli_dense,
# figure2 w8a-like), CRN full on w8a-like (d = 300), SSCN m=500 (sscn,
# cli_gram) and m=1000 (figure2 news20-like)
EIGH_SIZES = (10, 300, 500, 1000)
EIGH_TIMED_REPS = 25
# gates on the kernel's decomposition, in units of n eps (fp32): the
# residual ||H Q - Q diag(theta)||_F / ||H||_F and ||Q^T Q - I||_F; the CPU
# tests hold the emulation to 4 n eps (tests/test_torch_eigh_kernel.py)
EIGH_RES_EPS = 4
# the thetas against the plain version's (LAPACK's evd on the host), in
# units of eps ||H||_F; cuSOLVER's fp32 thetas (torch.linalg.eigh) lie
# ~1e-5 ||H||_F from both at n = 300 and are printed, not gated
EIGH_THETA_EPS = 16
# a dense symmetric eigh with eigenvectors: 9 n^3 flops (Golub and Van
# Loan, the symmetric QR algorithm with Q accumulated), the reference
# count of the kernel's bound
EIGH_FLOPS_PER_N3 = 9
SECULAR_FLOPS_PER_TERM = 7  # c^2, theta + lam, sq, two divisions, two adds
SECULAR_FLOPS_PER_IT = 12  # the Newton update and the safeguard


def _sscn_like(n, gen, device, empty=0.9):
    """B^T diag(w) B / rows with most of B's columns empty, as SSCN's
    coordinate Hessians on rcv1-like are (446 of 500 rows exactly 0)."""
    import torch

    B = torch.randn((4 * n, n), generator=gen, device=device)
    B = B * (torch.rand(n, generator=gen, device=device) >= empty)
    w = torch.rand(4 * n, generator=gen, device=device) * 0.25
    return (B * w[:, None]).T @ B / (4 * n)


def phase_eigh(dev):
    """The eigh kernel (csrc/eigh.cu) and the dense-spectrum Newton
    (csrc/subproblem.cu eig_secular): bits against their emulations at
    small sizes, and at the paths' sizes the decomposition's residuals,
    the thetas against cuSOLVER's, and the times beside the bound."""
    import torch

    from krylov_crn_tpu_torch.ops import eigh as E
    from krylov_crn_tpu_torch.ops import subproblem as sp
    from krylov_crn_tpu_torch.solvers.crn import LS_BLOCK
    from krylov_crn_tpu_torch.utils.profiling import (
        alternating_ms,
        device_time_per_call,
    )

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"bits": {}, "n": {}}
    # ---- bits against the emulations ----
    for n, dt, kind in ((8, torch.float32, "random"),
                        (33, torch.float32, "random"),
                        (70, torch.float32, "random"),
                        (33, torch.float64, "random"),
                        (60, torch.float32, "sscn_like")):
        H = (_symmetric(n, gen, dev) if kind == "random"
             else _sscn_like(n, gen, dev)).to(dt)
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        theta, Q = E.sym_eigh(H, sweeps=sweeps)
        torch.cuda.synchronize()
        emu = E.sym_eigh_emulated(H.cpu().numpy())
        same = (_same_bits(theta.cpu().numpy(), emu[0])
                and _same_bits(Q.cpu().numpy(), emu[1])
                and int(sweeps.item()) == E.sym_eigh_emulated.sweeps)
        out["bits"][f"eigh_{kind}_{n}_{dt}"] = same
        print(f"eigh: n {n} {kind} {dt}: kernel = emulation bit for bit "
              f"{same}, {E.sym_eigh_emulated.sweeps} sweeps")
        if not same:
            raise RuntimeError(f"eigh: the kernel differs from its "
                               f"emulation at n {n} ({kind}, {dt})")
    for m in (10, 70, 300):
        theta = torch.sort(torch.rand(m, generator=gen, device=dev)
                           - 0.1).values
        c = torch.randn(m, generator=gen, device=dev) * 0.1
        c[:3] = 0.0
        regs = 1e-3 * 2.0 ** torch.arange(LS_BLOCK, device=dev)
        r0 = torch.full((1,), 0.1, device=dev)
        lam, its = sp.eig_secular(theta, c, regs, r0)
        torch.cuda.synchronize()
        emu = sp.eig_secular_emulated(*(t.cpu().numpy() for t in (
            theta, c, regs, r0)))
        same = (_same_bits(lam.cpu().numpy(), emu[0])
                and _same_bits(its.cpu().numpy(), emu[1]))
        out["bits"][f"eig_secular_{m}"] = same
        print(f"eig_secular: m {m}, L {LS_BLOCK}: kernel = emulation bit "
              f"for bit {same}, Newton steps {emu[1].tolist()}")
        if not same:
            raise RuntimeError(f"eig_secular: the kernel differs from its "
                               f"emulation at m {m}")

    # ---- the paths' sizes, fp32 ----
    worst_theta = 0.0
    for n in EIGH_SIZES:
        eps = float(np.finfo(np.float32).eps)
        rec = {}
        for kind in ("random", "sscn_like"):
            H = (_symmetric(n, gen, dev) if kind == "random"
                 else _sscn_like(n, gen, dev))
            sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
            theta, Q = E.sym_eigh(H, sweeps=sweeps)
            th_lib = torch.linalg.eigh(H)[0]
            th_plain = E.sym_eigh_plain(H.cpu())[0].to(dev)
            Hd, Qd, td = H.double(), Q.double(), theta.double()
            hn = float(torch.linalg.norm(Hd))
            res = float(torch.linalg.norm(Hd @ Qd - Qd * td)) / hn
            orth = float(torch.linalg.norm(
                Qd.T @ Qd - torch.eye(n, dtype=torch.float64, device=dev)))
            th_err = float((theta - th_lib).abs().max())
            th_plain_err = float((theta - th_plain).abs().max())
            zeros = int((theta == 0).sum())
            lib_zeros = int((th_lib == 0).sum())
            rec[kind] = dict(sweeps=int(sweeps.item()), res=res, orth=orth,
                             theta_err=th_err, theta_plain_err=th_plain_err,
                             zeros=zeros, lib_zeros=lib_zeros,
                             lib_min=float(th_lib.min()),
                             min=float(theta.min()))
            print(f"eigh n={n} {kind}: {rec[kind]['sweeps']} sweeps; "
                  f"||HQ - Q diag(theta)|| / ||H|| {res:.3e} "
                  f"({res / (n * eps):.3f} n eps), ||Q^T Q - I|| {orth:.3e} "
                  f"({orth / (n * eps):.3f} n eps); max |theta - "
                  f"theta_cuSOLVER| / ||H|| {th_err / hn:.3e}, against "
                  f"LAPACK (plain) {th_plain_err / hn:.3e}; exact zeros "
                  f"{zeros} (cuSOLVER {lib_zeros}), min theta "
                  f"{rec[kind]['min']:.3e} (cuSOLVER "
                  f"{rec[kind]['lib_min']:.3e})")
            if not (res <= EIGH_RES_EPS * n * eps
                    and orth <= EIGH_RES_EPS * n * eps
                    and th_plain_err <= EIGH_THETA_EPS * eps * hn):
                raise RuntimeError(f"eigh n={n} {kind}: beyond the gates "
                                   f"({rec[kind]})")
            worst_theta = max(worst_theta, th_plain_err)
        H = _symmetric(n, gen, dev)
        kms, lms = alternating_ms(lambda v: E.sym_eigh(H)[0],
                                  lambda v: torch.linalg.eigh(H)[0],
                                  H[0], reps=EIGH_TIMED_REPS)
        Hc = H.cpu()
        t0 = time.perf_counter()
        for _ in range(3):
            E.sym_eigh_plain(Hc)
        plain_ms = (time.perf_counter() - t0) / 3 * 1e3
        bound_ms, bound_by = _bound(4 * (2 * n * n + n),
                                    EIGH_FLOPS_PER_N3 * n ** 3)
        rec.update(ms=min(kms), ms_runs=kms, library_ms=min(lms),
                   library_ms_runs=lms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        out["n"][n] = rec
        print(f"eigh n={n}: kernel {kms} ms, cuSOLVER (torch.linalg.eigh) "
              f"{lms} ms, plain (LAPACK evd on the host CPU) "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({EIGH_FLOPS_PER_N3} n^3 flops)")
    out["max_abs_err"] = worst_theta

    # ---- eig_secular at the paths' shapes: L = LS_BLOCK candidates ----
    sec = {}
    for m in EIGH_SIZES:
        theta = E.sym_eigh(_sscn_like(m, gen, dev) if m >= 500
                           else _symmetric(m, gen, dev))[0]
        c = torch.randn(m, generator=gen, device=dev) * 0.1
        c = torch.where(theta == 0, 0.0, c)
        regs = 1e-3 * 2.0 ** torch.arange(LS_BLOCK, device=dev)
        r0 = torch.full((1,), 0.1, device=dev)
        lam, its = sp.eig_secular(theta, c, regs, r0)
        lam_p, its_p = sp.secular_newton(theta, c, regs, r0.reshape(()))
        err = float((lam - lam_p).abs().max())
        kms, pms = alternating_ms(
            lambda v: sp.eig_secular(theta, c, regs, r0)[0],
            lambda v: sp.secular_newton(theta, c, regs, r0.reshape(()))[0],
            regs)
        steps = int(its.sum())
        nbytes = 4 * (2 * m + 2 * LS_BLOCK + 1) + 8 * LS_BLOCK
        flops = steps * (SECULAR_FLOPS_PER_TERM * m + SECULAR_FLOPS_PER_IT)
        bound_ms, bound_by = _bound(nbytes, flops)
        one = torch.zeros(1, device=dev)
        launch_ms = device_time_per_call(lambda v: v + 1.0, one)
        sec[m] = dict(ms=min(kms), ms_runs=kms, plain_ms=min(pms),
                      plain_ms_runs=pms, max_abs_err=err, newton_steps=steps,
                      bound_ms=bound_ms, bound_by=bound_by,
                      launch_ms=launch_ms)
        print(f"eig_secular m={m}, L={LS_BLOCK}: kernel {kms} ms, plain "
              f"(the Newton loop, a host read a step) {pms} ms, one small "
              f"kernel {launch_ms:.4f} ms; {steps} Newton steps, bound "
              f"{bound_ms:.3e} ms by {bound_by}; max |lambda - plain| "
              f"{err:.3e}; its {its.tolist()} (plain {its_p.tolist()})")
        if not torch.allclose(lam, lam_p, rtol=SUB_LAM_REL, atol=1e-8):
            raise RuntimeError(f"eig_secular m={m}: lambda {lam.tolist()} "
                               f"against plain {lam_p.tolist()}")
    out["secular"] = sec
    torch.cuda.empty_cache()
    return out


LS_STEPS = 10  # steps of the CRN full and SSCN steps eager against replayed
LS_BLOCKS_TRIED = (1, 2, 4, 8)  # line-search blocks timed on CRN full


def phase_ls_fused(dev):
    """The CRN "full" step (w8a-like) and the SSCN step (rcv1-like m=500)
    without host round trips: LS_STEPS steps eager against replayed, bit
    for bit, the steps' host reads counted; the SSCN panel and partials
    under sync debug mode "error"; wall, device time, busy share and host
    launch calls per step, eager and replayed; CRN full runs at each
    line-search block size."""
    import torch

    from krylov_crn_tpu_torch import (
        SSCN,
        CubicNewton,
        LogisticRegression,
    )
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.models.logistic import logreg_partials
    from krylov_crn_tpu_torch.ops.coords import gather_columns_dense
    from krylov_crn_tpu_torch.solvers import crn as tc
    from krylov_crn_tpu_torch.solvers import sscn as ts

    out = {}

    def steps(step, st0, k):
        st, rows = st0, []
        for i in range(k):
            st = step(st, i)
            rows.append(st)
        return rows

    def hold(tag, fields, eager, replayed, cnt, name):
        replays, blocks = f"{name}_replays", f"{name}_blocks"
        # a further block's graph is captured at its first use, with one
        # eager warm-up block
        warm = cnt[f"{name}_captures"]
        differ = [(i, f) for i, (e, r) in enumerate(zip(eager, replayed), 1)
                  for f in fields
                  if not torch.equal(getattr(e, f), getattr(r, f))]
        print(f"{tag}: {LS_STEPS} replayed steps against eager: "
              f"{'bit for bit' if not differ else f'differ at {differ[:6]}'}"
              f"; step replays {cnt[replays]}, further blocks "
              f"{cnt[blocks]}, the steps' host reads {cnt['ls_reads']}, "
              f"sym_eigh launches {cnt['eigh']}, eig_secular launches "
              f"{cnt['secular']}")
        if differ:
            raise RuntimeError(f"{tag}: replayed steps differ from the "
                               f"eager ones: {differ[:6]}")
        if not (cnt[replays] == LS_STEPS
                and cnt["ls_reads"] <= LS_STEPS + cnt[blocks]
                and cnt["eigh"] == LS_STEPS
                and cnt["secular"] == LS_STEPS + cnt[blocks] + warm):
            raise RuntimeError(f"{tag}: counts {cnt}")

    def measure(tag, eager_step, replay_step, st0, kernel):
        walls = {"eager": [], "replayed": []}
        for name in ("replayed", "eager", "eager", "replayed"):
            fn = replay_step if name == "replayed" else eager_step
            walls[name].append(_wall_ms(lambda: steps(fn, st0, LS_STEPS))
                               / LS_STEPS)
        rec = {}
        for name, fn in (("replayed", replay_step), ("eager", eager_step)):
            p = _profile_steps(lambda: steps(fn, st0, LS_STEPS), LS_STEPS,
                               kernel)
            w = min(walls[name])
            rec[name] = dict(p, wall_ms=w, wall_ms_runs=walls[name],
                             busy=p["device_ms"] / w)
            print(f"{tag}: {name} step: wall {walls[name]} ms, device "
                  f"{p['device_ms']:.3f} ms (windows "
                  f"{p['device_ms_windows']}), busy {p['device_ms'] / w:.1%}, "
                  f"host launch calls {p['launches']:.1f}, device kernels "
                  f"{p['kernels']:.1f}, {kernel} {p['named']:.1f}")
        return rec

    # ---- CRN full on w8a-like ----
    A, b = synthetic_logreg("w8a-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    crn = CubicNewton(loss=loss, reg_coef=1e-3, cubic_solver="full",
                      tolerance=0)
    crn.init_run(x0, 42)
    data, bt, st0 = loss.data, loss.b_t, crn.state
    kw = dict(l2=loss.l2, beta=crn.beta, solver_eps=crn.solver_eps,
              solver_it_max=crn.solver_it_max, tolerance=0.0,
              ls_max=crn.ls_max, reg_ceil=1e6)
    gkw = dict(kw, adt=torch.float32)
    graphs = tc._FullGraphs(dev)
    eager_step = lambda st, i: tc.crn_step_full(
        data, bt, st, accum_dtype=torch.float32, **kw)
    replay_step = lambda st, i: graphs.step(data, bt, st, gkw)
    eager = steps(eager_step, st0, LS_STEPS)
    t0 = time.perf_counter()
    replay_step(st0, 0)  # the captures, their warm-up steps included
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _reset_counts()
    replayed = steps(replay_step, st0, LS_STEPS)
    torch.cuda.synchronize()
    hold("ls_fused crn (w8a-like)", tc.CRNState._fields, eager, replayed,
         _counts(), "crn")
    out["crn"] = measure("ls_fused crn (w8a-like)", eager_step, replay_step,
                         st0, "sym_eigh")
    out["crn"]["capture_s"] = capture_s
    del graphs, eager, replayed

    # the line-search block: 20-step CRN runs from x0, captures included
    blocks = {}
    saved = tc.LS_BLOCK
    try:
        for B in LS_BLOCKS_TRIED:
            tc.LS_BLOCK = B
            alg = CubicNewton(loss=loss, reg_coef=1e-3, cubic_solver="full",
                              tolerance=0)
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            alg.run(x0, it_max=20)
            torch.cuda.synchronize()
            cnt = _counts()
            blocks[B] = dict(seconds=time.perf_counter() - t0,
                             reads=cnt["ls_reads"],
                             further=cnt["crn_blocks"],
                             value=float(alg.state.value))
            print(f"ls_fused crn block {B}: 20 steps in "
                  f"{blocks[B]['seconds']:.3f} s (captures included), "
                  f"host reads {cnt['ls_reads']}, further blocks "
                  f"{cnt['crn_blocks']}, value {blocks[B]['value']:.9g}")
    finally:
        tc.LS_BLOCK = saved
    out["crn_blocks"] = blocks

    # ---- SSCN m=500 on rcv1-like ----
    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    loss = LogisticRegression(A, b, dtype=np.float32, device=dev)
    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=500, tolerance=0)
    alg.init_run(x0, 42)
    data, bt, st0 = loss.data, loss.b_t, alg.state
    gen = torch.Generator().manual_seed(42)
    Is = [ts.draw_coordinates(gen, A.shape[1], 500, dev)
          for _ in range(LS_STEPS)]
    # the panel and the partials read nothing back (after a first call)
    reads = {}
    for name, fn in (("gather_columns_dense",
                      lambda: gather_columns_dense(data, Is[0])),
                     ("logreg_partials", lambda: logreg_partials(
                         data, bt, st0.Ax, st0.x, Is[0]))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            reads[name] = False
        except RuntimeError:
            reads[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"ls_fused sscn: reads the host under sync debug mode 'error': "
          f"{reads}")
    if any(reads.values()):
        raise RuntimeError(f"ls_fused sscn: host reads {reads}")
    skw = dict(l2=loss.l2, beta=alg.beta, solver_eps=alg.solver_eps,
               solver_it_max=alg.solver_it_max, ls_max=alg.ls_max,
               reg_ceil=1e6)
    sgraphs = ts._SSCNGraphs(dev)
    eager_step = lambda st, i: ts.sscn_step(
        data, bt, st, Is[i], accum_dtype=torch.float32, **skw)
    replay_step = lambda st, i: sgraphs.step(
        data, bt, st, Is[i], dict(skw, adt=torch.float32))
    eager = steps(eager_step, st0, LS_STEPS)
    t0 = time.perf_counter()
    replay_step(st0, 0)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _reset_counts()
    replayed = steps(replay_step, st0, LS_STEPS)
    torch.cuda.synchronize()
    hold("ls_fused sscn (rcv1-like, m 500)", ts.SSCNState._fields, eager,
         replayed, _counts(), "sscn")
    out["sscn"] = measure("ls_fused sscn (rcv1-like, m 500)", eager_step,
                          replay_step, st0, "sym_eigh")
    out["sscn"].update(capture_s=capture_s, host_reads=reads)
    del sgraphs, eager, replayed
    torch.cuda.empty_cache()
    return out


def phase_news20(dev):
    """The news20-like stand-in (19,996 x 1,355,191, 22 build panels):
    the same protocol and gates as ``main`` at d = 1.36M."""
    return _gram_race("news20", "news20-like", dev)


def phase_bf16_head(dev, tag, alg, fp32_rec, it_max):
    """The bf16 Lanczos head (GramKrylov(bf16_head=True)) on the K that
    the fp32 race ``fp32_rec`` built (``alg.gd``), with its f*: the m=10
    race to a certified 1e-8 gap within ``it_max`` iterations, exact
    boundary values that never rise, the switch to the fp32 K, every
    Lanczos product on the bf16 K through the matvec kernel and every fp32
    K-matvec through SYMV; the card's bf16 K against the CPU's rounding of
    the same K, one bf16 product against its plain version and fp64, and
    a step's device time for the 10 bf16 products and the refresh beside
    10 SYMVs."""
    import dataclasses

    import torch

    from krylov_crn_tpu_torch import GramKrylov
    from krylov_crn_tpu_torch.ops.matvec import matvec, matvec_plain
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.solvers.krylov_gram import (
        _lr_matvec,
        _refresh_images,
    )
    from krylov_crn_tpu_torch.utils.profiling import (
        alternating_ms,
        device_time_per_call,
    )

    K = alg.gd.K
    n = K.shape[0]
    gd = dataclasses.replace(alg.gd, K_lr=K.to(torch.bfloat16))
    # the card's rounding to bf16 is the CPU's (round to nearest even,
    # which the CPU tests hold to the JAX package's bits)
    same = torch.equal(gd.K_lr.view(torch.int16).cpu(),
                       K.cpu().to(torch.bfloat16).view(torch.int16))
    print(f"{tag} bf16_head: K_lr ({n} x {n}, {gd.K_lr.numel() * 2 / 1e9:.2f} "
          f"GB beside K) equals the CPU's rounding of K bit for bit: {same}")
    if not same:
        raise RuntimeError(f"{tag} bf16_head: the card's bf16 K differs from "
                           "the CPU's rounding")
    loss, f_star = alg.loss, fp32_rec["f_star"]
    f_opt, x_opt = loss.f_opt, loss.x_opt
    x0 = np.ones(loss.A_host.shape[1]) * 0.5
    head = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                      device=dev, label="gram-bf16-head", gram_data=gd,
                      bf16_head=True)
    switch = []
    enter = head._maybe_enter_fp32_tail

    def watched(grad_norm):
        lr = head._use_lr
        enter(grad_norm)
        if lr and not head._use_lr:
            # run_fused has just recorded the chunk's gradient norms: the
            # fp32 K takes over after this many iterations
            switch.append(len(head.trace.metrics["grad_norm"]))

    head._maybe_enter_fp32_tail = watched
    head.init_run(x0, 42)
    head.initialized = True
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = head.run_fused(x0, it_max=it_max, chunk=24, certify=True)
    torch.cuda.synchronize()
    race_s = time.perf_counter() - t0
    cnt = _counts()
    loss.f_opt, loss.x_opt = f_opt, x_opt  # the fp32 race's f* stays
    bf16_key = f"{n}x{n}_bfloat16"
    lr_launches = cnt["matvec_shapes"].get(bf16_key, 0)
    print(f"{tag} bf16_head: bf16 matvec launches at {bf16_key} "
          f"{lr_launches}, _lr_matvec calls on the card {cnt['lr_calls']}; "
          f"symv launches {cnt['symv']}, k_matvec calls {cnt['kmatvec_calls']}"
          f"; graph replays {cnt['graph_replays']} (captures "
          f"{cnt['graph_captures']}), subproblem launches "
          f"{cnt['subproblem']}")
    if not cnt["graph_replays"] >= head.it:
        raise RuntimeError(f"{tag} bf16_head: {cnt['graph_replays']} graph "
                           f"replays for {head.it} iterations")
    if not (lr_launches == cnt["lr_calls"] and lr_launches > 0):
        raise RuntimeError(f"{tag} bf16_head: bf16 products bypassed the "
                           f"kernel: {lr_launches} launches vs "
                           f"{cnt['lr_calls']} calls")
    if not (cnt["symv"] == cnt["kmatvec_calls"] and cnt["symv"] > 0):
        raise RuntimeError(f"{tag} bf16_head: fp32 K-matvecs bypassed SYMV")
    its, gaps, cross, cross_t, bfs = _certified_crossing(
        f"{tag} bf16_head", trace, f_star, it_max)
    print(f"{tag} bf16_head: race {race_s:.3f} s for {head.it} iterations "
          f"(fp32 race {fp32_rec['race_s']:.3f} s for "
          f"{fp32_rec['iterations']}); crossing at iteration {cross}, "
          f"{cross_t:.3f} s into the race (fp32 {fp32_rec['crossing_it']}, "
          f"{fp32_rec['crossing_t']:.3f} s); switch to the fp32 K after "
          f"iteration {switch}; final certified gap {gaps[-1]:.3e}, best "
          f"{min(gaps):.3e}; rollbacks {trace.metrics['rollback_its']}")
    if not switch:
        raise RuntimeError(f"{tag} bf16_head: the switch to the fp32 K never "
                           "fired")

    # one product at the path's shape: the kernel against its plain
    # version on the bf16-rounded q, both against fp64 of the same function
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.rand(n, generator=gen, device=dev).to(torch.bfloat16).float()
    y, y2, yp = matvec(gd.K_lr, q), matvec(gd.K_lr, q), matvec_plain(gd.K_lr, q)
    ref = gd.K_lr.double() @ q.double()
    torch.cuda.synchronize()
    rel, rel_plain = _rel(y, ref), _rel(yp, ref)
    err = float((y - yp).abs().max())
    print(f"{tag} bf16_head: bf16 product rel err {rel:.3e} (plain "
          f"{rel_plain:.3e}), max |kernel - plain| {err:.3e}")
    if not rel < MATVEC_TOL:
        raise RuntimeError(f"{tag} bf16_head: bf16 matvec rel err {rel:.3e}")
    if not torch.equal(y, y2):
        raise RuntimeError(f"{tag} bf16_head: bf16 matvec not bitwise "
                           "reproducible")

    # a step's device time: the head's 10 bf16 products and the refresh of
    # the 10 images, against the tail's 10 SYMVs (both with a cold L2)
    Vw = torch.rand((10, n), generator=gen, device=dev) * 1e-3
    Vb = torch.rand(10, generator=gen, device=dev)

    def head_products(x):
        for _ in range(10):
            y = _lr_matvec(gd.K_lr, x)
        _refresh_images(gd, Vb, Vw)
        return y

    def fp32_products(x):
        for _ in range(10):
            y = symv(K, x)
        return y

    x = torch.rand(n, generator=gen, device=dev)
    hms, sms = alternating_ms(head_products, fp32_products, x, reps=9,
                              flush_l2=True)
    refresh_ms = device_time_per_call(lambda v: _refresh_images(gd, Vb, Vw)[0],
                                      x, reps=9, flush_l2=True)
    print(f"{tag} bf16_head: per step, 10 bf16 products + refresh {hms} ms "
          f"(refresh alone {refresh_ms:.4f} ms) against 10 SYMVs {sms} ms")
    del gd, head
    torch.cuda.empty_cache()
    return dict(race_s=race_s, iterations=its[-1] if its else 0,
                crossing_it=cross, crossing_t=cross_t, switch_it=switch[0],
                final_gap=gaps[-1],
                best_gap=min(gaps), boundary_fs=bfs,
                rollback_its=list(trace.metrics["rollback_its"]),
                lr_launches=lr_launches, lr_calls=cnt["lr_calls"],
                symv_launches=cnt["symv"],
                subproblem_launches=cnt["subproblem"],
                fold_launches=cnt["fold"],
                graph_replays=cnt["graph_replays"], rel_err=rel,
                rel_err_plain=rel_plain, max_abs_err=err,
                step_head_ms=hms, step_symv_ms=sms, refresh_ms=refresh_ms,
                fp32_race_s=fp32_rec["race_s"],
                fp32_crossing_it=fp32_rec["crossing_it"])


def phase_kernel_on_K(dev, K, tag="rcv1-like"):
    """SYMV against its plain version, fp64 and ``torch.mv`` on a K that
    a driven path built (``tag`` names the path's problem), with times;
    then ``symv_at``, the entry that the cached Gram step graphs launch
    (K read through a ``KSlot``), against the plain version and against
    ``symv`` bit for bit, timed against it."""
    import torch

    from krylov_crn_tpu_torch.ops.symv import KSlot, symv, symv_at, symv_plain
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

    slot = KSlot(n, K.dtype, dev)
    slot.point(K)
    ya = symv_at(slot, x)
    at_err = _hold_to_plain(f"kernel@K {tag} symv_at", ya, yp, ref)
    if not torch.equal(ya, y):
        raise RuntimeError(f"kernel@K {tag}: symv_at differs from symv in "
                           f"{int((ya != y).sum())} of {n} entries")
    ams, dms = alternating_ms(lambda v: symv_at(slot, v),
                              lambda v: symv(K, v), x)
    at_ms, direct_ms = min(ams), min(dms)
    print(f"kernel@K {tag} n={n}: symv_at bit for bit symv, max |symv_at - "
          f"plain| {at_err:.3e}; symv_at {ams} ms, symv {dms} ms "
          f"({at_ms / direct_ms - 1:+.2%})")
    return dict(rel_err=rel, rel_err_plain=rel_plain, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, ms_runs=kms, plain_ms_runs=pms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                at_ms=at_ms, at_ms_runs=ams, at_direct_ms=direct_ms,
                at_direct_ms_runs=dms, at_max_abs_err=at_err)


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
          f"{m['cg_its']}, CG block replays {m['cg_replays']}, host reads "
          f"{m['host_reads']} per iteration; symv launches {cnt['symv']}, "
          f"k_matvec calls on the card {cnt['kmatvec_calls']}")
    if not rb:
        raise RuntimeError("rollback: GramCRN never rolled back")
    if not (len(checks) == len(rb) and all(c["restored"] for c in checks)):
        raise RuntimeError("rollback: the state after a rollback is not the "
                           "verified snapshot")
    if any(f2 > f1 for f1, f2 in zip(fs, fs[1:])):
        raise RuntimeError(f"rollback: exact values increased: {fs}")
    if not (cnt["symv"] == cnt["kmatvec_calls"] and cnt["symv"] > 0):
        raise RuntimeError("rollback: K-matvecs bypassed the kernel")
    _cg_replayed("rollback", m, cnt)
    return dict(seconds=secs, rollback_its=list(rb),
                restored=[c["restored"] for c in checks], exact_fs=fs,
                cg_its=list(m["cg_its"]), cg_replays=list(m["cg_replays"]),
                host_reads=list(m["host_reads"]), launches=cnt["symv"],
                kmatvec_calls=cnt["kmatvec_calls"], fold_launches=cnt["fold"])


def _cg_replayed(tag, m, cnt):
    """GramCRN's CG ran in replayed blocks: a replay for every block, at
    most CG_BLOCK iterations each, and fewer host reads than CG
    iterations."""
    from krylov_crn_tpu_torch.solvers.crn_gram import CG_BLOCK

    its, reps, reads = (sum(m[k]) for k in ("cg_its", "cg_replays",
                                            "host_reads"))
    print(f"{tag}: GramCRN CG {its} iterations in {reps} replayed blocks of "
          f"{CG_BLOCK} ({cnt['cg_captures']} captures), {reads} host reads "
          f"({reads / max(its, 1):.3f} per CG iteration)")
    if not (reps == cnt["cg_replays"] and its / CG_BLOCK <= reps < its
            and reads < its):
        raise RuntimeError(f"{tag}: GramCRN's CG ran {its} iterations in "
                           f"{reps} replays with {reads} host reads")


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
    # timed: the tool's shape, the mesh band, and the bf16 K of the head
    # on each Gram problem (rcv1-like's n_pad 20480, news20-like's 20224)
    timed = {(20480, 20480, torch.float32), (20480, 20480, torch.bfloat16),
             (5120, 20480, torch.float32), (20224, 20224, torch.bfloat16)}
    # (5120, 20480): the row band of rcv1-like's K under a mesh of four
    for n, m in ((20480, 20480), (20224, 20224), (5120, 20480), (49749, 300),
                 (300, 49749), (1003, 3333)):
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
            if (n, m, dtype) in timed:
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
    kry_its = out["krylov"]["iterations"]
    print(f"dense: matvec launches {launches} ({cnt['matvec_shapes']}), "
          f"dense-branch products on the card {calls} (replays counted), "
          f"symv launches {cnt['symv']}; CubicKrylov graph replays "
          f"{cnt['krylov_replays']} for {kry_its} iterations (captures "
          f"{cnt['krylov_captures']}), "
          f"subproblem launches {cnt['subproblem']}")
    if not (launches == calls and launches > 0):
        raise RuntimeError(f"dense products bypassed the kernel: {launches} "
                           f"launches vs {calls} calls")
    # one launch a step: a capture's eager warm-up step, or a replay
    if not (cnt["krylov_replays"] == kry_its
            and cnt["subproblem"] == kry_its + cnt["krylov_captures"]):
        raise RuntimeError(f"dense: {cnt['krylov_replays']} replays and "
                           f"{cnt['subproblem']} subproblem launches for "
                           f"{kry_its} CubicKrylov steps")
    _ls_replayed("dense", cnt, crn_its=out["crn"]["iterations"])
    out.update(launches=launches, dense_calls=calls,
               matvec_shapes=cnt["matvec_shapes"],
               graph_replays=cnt["krylov_replays"],
               subproblem_launches=cnt["subproblem"],
               eigh_launches=cnt["eigh"], secular_launches=cnt["secular"],
               crn_replays=cnt["crn_replays"], crn_blocks=cnt["crn_blocks"],
               ls_reads=cnt["ls_reads"], fold_launches=cnt["fold"],
               reading_offset=_reading_offset("dense", float(loss.f_opt),
                                              f_star),
               reading_parts=_reading_parts(loss, A, b, f_star))
    return out


def phase_sparse(dev):
    """CubicKrylov on rcv1-like through the CSR branch: fp32 on the card
    (twice, replayed) against fp64 on the CPU and against eager steps on
    the card, 10 iterations."""
    import torch

    from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.spmv import spmv_csr
    from krylov_crn_tpu_torch.solvers import krylov_crn as kc

    A, b = synthetic_logreg("rcv1-like", seed=0)
    x0 = np.ones(A.shape[1]) * 0.5
    # a CSR product's host reads once set up (the capture's warm-up step
    # makes its first call): the branch replays only if there are none
    M = LogisticRegression(A, b, dtype=np.float32, device=dev).data.a
    v = torch.rand(A.shape[1], device=dev)
    prod = M.values() * v.index_select(0, M.col_indices())
    reads = {}
    for name, fn in (
            ("index_select", lambda: v.index_select(0, M.col_indices())),
            ("segment_reduce", lambda: torch.segment_reduce(
                prod, "sum", offsets=M.crow_indices())),
            ("spmv_csr", lambda: spmv_csr(M, v))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            reads[name] = False
        except RuntimeError:
            reads[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"sparse: reads the host under sync debug mode 'error' (after a "
          f"first call): {reads}")
    _reset_counts()
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
    cnt = _counts()
    # the replayed run against eager steps from the same initial state
    st = kc.initial_state(loss, x0, 1e-3, kc.KrylovState)
    kw = alg._step_kwargs()
    for _ in range(10):
        st = kc.krylov_step(loss.data, loss.b_t, st, **kw)
    eager_same = torch.equal(st.x, runs["f32_card_again"]["x"])
    same = torch.equal(runs["f32_card"]["x"], runs["f32_card_again"]["x"])
    f64, f32 = runs["f64_cpu"]["f"], runs["f32_card"]["f"]
    rel = abs(f32 - f64) / abs(f64)
    # cuSPARSE's CSR product (not used by the port), for the record
    ys = [M @ v for _ in range(20)]
    cusparse_same = all(torch.equal(ys[0], y) for y in ys)
    print(f"sparse: fp32 card vs fp64 CPU, relative {rel:.3e}; two card runs "
          f"bitwise equal: {same}; replayed equal to 10 eager steps: "
          f"{eager_same}; dense products {cnt['dense_calls']}; cuSPARSE "
          f"CSR @ bitwise equal over 20 calls: {cusparse_same}; CubicKrylov "
          f"graph replays {cnt['krylov_replays']} (captures "
          f"{cnt['krylov_captures']}), subproblem launches "
          f"{cnt['subproblem']}")
    if not (same and eager_same):
        raise RuntimeError("fp32 card runs of the CSR path differ")
    if cnt["dense_calls"]:
        raise RuntimeError("the CSR path ran dense products")
    if any(reads.values()) or not (
            cnt["krylov_replays"] == 20 and cnt["krylov_captures"] == 2
            and cnt["subproblem"] == 22):
        raise RuntimeError(f"sparse: the CSR step's path: host reads "
                           f"{reads}, {cnt['krylov_replays']} replays, "
                           f"{cnt['krylov_captures']} captures")
    if not rel <= SPARSE_REL_TOL:
        raise RuntimeError(f"sparse: fp32 card loss {f32!r} vs fp64 CPU "
                           f"{f64!r}: relative {rel:.3e}")
    return dict(f64_cpu=f64, f32_card=f32, rel=rel, runs_equal=same,
                eager_equal=eager_same, cusparse_repeatable=cusparse_same,
                host_reads=reads, graph_replays=cnt["krylov_replays"],
                subproblem_launches=cnt["subproblem"],
                fold_launches=cnt["fold"],
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
    from krylov_crn_tpu_torch.ops.eigh import sym_eigh
    from krylov_crn_tpu_torch.ops.math import fold
    from krylov_crn_tpu_torch.ops.subproblem import (
        eig_secular,
        tridiag_secular,
    )
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.solvers.crn import crn_step_full, read_resolved
    from krylov_crn_tpu_torch.solvers.crn_gram import cg_rep
    from krylov_crn_tpu_torch.solvers.krylov_crn import krylov_step
    from krylov_crn_tpu_torch.solvers.krylov_gram import (
        _lr_matvec,
        gram_krylov_step,
    )
    from krylov_crn_tpu_torch.solvers.sscn import sscn_step

    symv.launches = k_matvec.cuda_calls = _lr_matvec.cuda_calls = 0
    matvec.launches = dense_matvec.cuda_calls = 0
    matvec.shape_launches.clear()
    tridiag_secular.launches = fold.launches = 0
    sym_eigh.launches = eig_secular.launches = read_resolved.count = 0
    for step in (crn_step_full, sscn_step):
        step.graph_captures = step.graph_replays = step.block_replays = 0
    gram_krylov_step.graph_captures = gram_krylov_step.graph_replays = 0
    krylov_step.graph_captures = krylov_step.graph_replays = 0
    cg_rep.block_replays = cg_rep.graph_captures = cg_rep.iterations = 0


def _counts():
    from krylov_crn_tpu_torch.ops.gram import k_matvec
    from krylov_crn_tpu_torch.ops.matvec import matvec
    from krylov_crn_tpu_torch.ops.spmv import dense_matvec
    from krylov_crn_tpu_torch.ops.eigh import sym_eigh
    from krylov_crn_tpu_torch.ops.math import fold
    from krylov_crn_tpu_torch.ops.subproblem import (
        eig_secular,
        tridiag_secular,
    )
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.solvers.crn import crn_step_full, read_resolved
    from krylov_crn_tpu_torch.solvers.crn_gram import cg_rep
    from krylov_crn_tpu_torch.solvers.krylov_crn import krylov_step
    from krylov_crn_tpu_torch.solvers.krylov_gram import (
        _lr_matvec,
        gram_krylov_step,
    )
    from krylov_crn_tpu_torch.solvers.sscn import sscn_step

    return dict(symv=symv.launches, kmatvec_calls=k_matvec.cuda_calls,
                eigh=sym_eigh.launches, secular=eig_secular.launches,
                ls_reads=read_resolved.count,
                crn_replays=crn_step_full.graph_replays,
                crn_captures=crn_step_full.graph_captures,
                crn_blocks=crn_step_full.block_replays,
                sscn_replays=sscn_step.graph_replays,
                sscn_captures=sscn_step.graph_captures,
                sscn_blocks=sscn_step.block_replays,
                lr_calls=_lr_matvec.cuda_calls,
                matvec=matvec.launches, dense_calls=dense_matvec.cuda_calls,
                matvec_shapes={f"{n}x{m}_{dt}": k for (n, m, dt), k
                               in matvec.shape_launches.items()},
                subproblem=tridiag_secular.launches, fold=fold.launches,
                graph_captures=gram_krylov_step.graph_captures,
                graph_replays=gram_krylov_step.graph_replays,
                krylov_captures=krylov_step.graph_captures,
                krylov_replays=krylov_step.graph_replays,
                cg_captures=cg_rep.graph_captures,
                cg_replays=cg_rep.block_replays,
                cg_its=cg_rep.iterations)


def _ls_replayed(tag, cnt, crn_its=None, sscn_its=None, exact=True):
    """The CRN "full" and SSCN steps of a phase replayed their graphs:
    one step replay per iteration (at least one per iteration where a
    warm-up step ran too, ``exact=False``), the steps' own host reads (the
    line-search flag) at most one per step plus one per further block,
    and the eigh and Newton kernels launched on every step."""
    steps = cnt["crn_replays"] + cnt["sscn_replays"]
    blocks = cnt["crn_blocks"] + cnt["sscn_blocks"]
    print(f"{tag}: CRN full graph replays {cnt['crn_replays']} (further "
          f"blocks {cnt['crn_blocks']}), SSCN graph replays "
          f"{cnt['sscn_replays']} (further blocks {cnt['sscn_blocks']}); "
          f"the steps' host reads {cnt['ls_reads']}; sym_eigh launches "
          f"{cnt['eigh']}, eig_secular launches {cnt['secular']}")
    for name, its in (("crn", crn_its), ("sscn", sscn_its)):
        got = cnt[f"{name}_replays"]
        if its is not None and not (got == its if exact else got >= its):
            raise RuntimeError(f"{tag}: {got} {name} step replays for {its} "
                               "iterations")
    if not cnt["ls_reads"] <= steps + blocks:
        raise RuntimeError(f"{tag}: {cnt['ls_reads']} host reads for "
                           f"{steps} steps and {blocks} further blocks")
    if not (cnt["eigh"] >= steps and cnt["secular"] >= steps + blocks
            and steps > 0):
        raise RuntimeError(f"{tag}: the steps bypassed the kernels: {cnt}")


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
    for i, (g, cg, rp, rd) in enumerate(zip(gaps, m["cg_its"],
                                            m["cg_replays"],
                                            m["host_reads"]), 1):
        print(f"cli_gram: GramCRN it {i}: {it_secs[i - 1]:.3f} s, exact gap "
              f"{g:.3e}, CG iterations {cg}, CG block replays {rp}, host "
              f"reads {rd}")
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
          f"card {cnt['kmatvec_calls']}, matvec launches {cnt['matvec']}; "
          f"GramKrylov's graph replays {cnt['graph_replays']}, subproblem "
          f"launches {cnt['subproblem']}")
    if not cnt["graph_replays"] >= kry.it > 0:
        raise RuntimeError(f"cli_gram: GramKrylov replayed "
                           f"{cnt['graph_replays']} steps of {kry.it}")
    _cg_replayed("cli_gram", m, cnt)
    _ls_replayed("cli_gram", cnt, sscn_its=sscn.it)
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
                cg_its=list(m["cg_its"]), cg_replays=list(m["cg_replays"]),
                host_reads=list(m["host_reads"]),
                rollback_its=list(m.get("rollback_its", [])),
                sscn_gap=s_gap, sscn_jax_gap=jax_gap,
                sscn_seconds=sscn.trace.ts[-1], f_opt=grid.f_opt,
                launches=cnt["symv"], kmatvec_calls=cnt["kmatvec_calls"],
                graph_replays=cnt["graph_replays"],
                subproblem_launches=cnt["subproblem"],
                eigh_launches=cnt["eigh"], secular_launches=cnt["secular"],
                fold_launches=cnt["fold"])


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
              f"{f:.17g}; further line-search blocks "
              f"{sum(alg.trace.metrics['ls_blocks'])}")
        if key == "f32_card_again":  # the card runs' counts
            cnt = _counts()
            _ls_replayed("sscn", cnt, sscn_its=2 * SSCN_ITS)
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
                solver_it={k: r["solver_it"] for k, r in runs.items()},
                eigh_launches=cnt["eigh"], secular_launches=cnt["secular"],
                sscn_replays=cnt["sscn_replays"], ls_reads=cnt["ls_reads"],
                fold_launches=cnt["fold"])


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
          f"{cnt['dense_calls']}, symv launches {cnt['symv']}; CubicKrylov "
          f"graph replays {cnt['krylov_replays']} for {grid.krylov.it} "
          f"iterations, subproblem launches {cnt['subproblem']}")
    if not (cnt["matvec"] == cnt["dense_calls"] and cnt["matvec"] > 0):
        raise RuntimeError(f"cli_dense: dense products bypassed the kernel: "
                           f"{cnt['matvec']} launches vs "
                           f"{cnt['dense_calls']} calls")
    if not (cnt["krylov_replays"] == grid.krylov.it
            and cnt["subproblem"] == grid.krylov.it + cnt["krylov_captures"]):
        raise RuntimeError(f"cli_dense: {cnt['krylov_replays']} replays for "
                           f"{grid.krylov.it} CubicKrylov steps")
    _ls_replayed("cli_dense", cnt, crn_its=grid.crn.it,
                 sscn_its=grid.sscn[0].it)
    if not gaps["crn"] <= DSPACE_GAP:
        raise RuntimeError(f"cli_dense: CRN final gap {gaps['crn']:.3e} "
                           f"above {DSPACE_GAP}")
    if not all(np.isfinite(g) for g in gaps.values()):
        raise RuntimeError(f"cli_dense: non-finite gaps {gaps}")
    return dict(seconds=secs, gaps=gaps, launches=cnt["matvec"],
                dense_calls=cnt["dense_calls"],
                matvec_shapes=cnt["matvec_shapes"],
                graph_replays=cnt["krylov_replays"],
                subproblem_launches=cnt["subproblem"],
                eigh_launches=cnt["eigh"], secular_launches=cnt["secular"],
                fold_launches=cnt["fold"])


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
        syrk_split_P,
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
    build_K_device.panels = syrk_split_P.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K = build_K_device(A, n_pad, np.float32, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k_build = _split_build_ok("skew", A, K)
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
    return dict(build_s=build_s, k_build=k_build, rel_err=rel,
                symv_rel_err=symv_rel, max_abs_err=err,
                nnz=int(A.nnz), panels=int(nblk),
                longest_panel=int(lens.max()))


SPLITK_MATVEC_TOL = 1e-6  # the split K's K-matvec error against fp64
SPLITK_VS_SGEMM = 4.0  # ... and against the fp32 SGEMM's, same run


def phase_splitk(card, panels):
    """The port of tools/measure_splitk.py: the split build's accuracy on
    rcv1-like's first 4,096 rows against host fp64 beside a direct fp32
    SGEMM's (and two other contraction orders of the split, printed), the
    panel step split against SGEMM, the card's split P
    against its plain version, and the whole builds of rcv1-like and
    news20-like. Gates: the split's K-matvec error <= 1e-6 and <= 4x the
    SGEMM's; P within ORDER_GATE (0.05) of the any-order bound of two fp32
    sums of the same exact terms (the sound product reads ~6e-3 of it),
    and the control, P rounded to bf16, beyond it (the bound alone would
    pass a bf16 output); every build panel through the split (``panels``:
    each problem's count, from phases main and news20) and each K bitwise
    symmetric."""
    from krylov_crn_tpu_torch.tools.measure_splitk import measure

    t0 = time.perf_counter()
    out = measure()
    out["seconds"] = time.perf_counter() - t0
    print(f"splitk ({out['seconds']:.1f} s): {json.dumps(out)}")
    acc, pg, vp = out["accuracy"], out["panel_gemm"], out["split_vs_plain"]
    for tag in acc:
        g = pg[tag]
        print(f"splitk {tag}: K-matvec rel err {acc[tag]['matvec_rel']:.3e}, "
              f"elementwise {acc[tag]['elem_max_rel']:.3e}, dense panel "
              f"{g['dense_elem_rel']:.3e}; panel step {g['ms']:.3f} ms "
              f"({g['tflops']:.1f} TFLOP/s of B B^T), bound "
              f"{g['bound_ms']:.3f} ms by {g['bound_by']} at "
              f"{g['peak_tflops']} TFLOP/s ({card})")
    print(f"splitk: card P against plain max |diff| {vp['max_abs_diff']:.3e}, "
          f"{vp['max_rel_to_order_bound']:.3e} of the order bound (gate "
          f"{vp['gate']}; P rounded to bf16 "
          f"{vp['bf16_out_rel_to_order_bound']:.3e})")
    for name, rec in out["build"].items():
        print(f"splitk build {name}: {rec['build_s']:.3f} s")
        _split_rec_ok(f"splitk {name}", rec, panels[name])
    split, sgemm = acc["split"]["matvec_rel"], acc["sgemm_fp32"]["matvec_rel"]
    if not (split <= SPLITK_MATVEC_TOL and split <= SPLITK_VS_SGEMM * sgemm):
        raise RuntimeError(f"splitk: K-matvec rel err {split:.3e} (limit "
                           f"{SPLITK_MATVEC_TOL}, and {SPLITK_VS_SGEMM} x "
                           f"SGEMM's {sgemm:.3e})")
    if not (vp["max_rel_to_order_bound"] <= vp["gate"]
            < vp["bf16_out_rel_to_order_bound"]):
        raise RuntimeError(f"splitk: card P off its plain version, or the "
                           f"gate would pass a bf16 output: {vp}")
    return out


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
              f"the card {cnt['dense_calls']}; CubicKrylov graph replays "
              f"{cnt['krylov_replays']} (captures {cnt['krylov_captures']}),"
              f" subproblem launches {cnt['subproblem']}")
        if not (cnt["matvec"] == cnt["dense_calls"] and cnt["matvec"] > 0):
            raise RuntimeError("figure2 w8a-like: dense products bypassed "
                               "the kernel")
        if not (cnt["krylov_replays"] > 0
                and cnt["subproblem"] == cnt["krylov_replays"]
                + cnt["krylov_captures"]):
            raise RuntimeError("figure2 w8a-like: CubicKrylov steps ran "
                               "eagerly")
        # each run's warm-up step is a step of its own
        _ls_replayed("figure2 w8a-like", cnt,
                     crn_its=curves["CRN"]["its"][-1],
                     sscn_its=curves["SSCN (m=10)"]["its"][-1], exact=False)
        for alg in ("CRN", "Krylov CRN (m=10)"):
            if not gaps[alg] <= DSPACE_GAP:
                raise RuntimeError(f"figure2 w8a-like: {alg} final gap "
                                   f"{gaps[alg]:.3e} above {DSPACE_GAP}")
        out[name] = dict(seconds=secs, f_star=data["f_star"], final_gaps=gaps,
                         reading_offset=off,
                         matvec_launches=cnt["matvec"],
                         matvec_shapes=cnt["matvec_shapes"],
                         dense_calls=cnt["dense_calls"],
                         graph_replays=cnt["krylov_replays"],
                         subproblem_launches=cnt["subproblem"],
                         eigh_launches=cnt["eigh"],
                         secular_launches=cnt["secular"],
                         fold_launches=cnt["fold"],
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
        if not cnt["graph_replays"] >= kry.it > 0:
            raise RuntimeError(f"figure2 news20-like: GramKrylov replayed "
                               f"{cnt['graph_replays']} steps of {kry.it}")
        _reset_counts()
        t0 = time.perf_counter()
        curves["SSCN (m=1000)"], sscn = rf.run_sscn(loss, b, x0, 50, 1000)
        torch.cuda.synchronize()
        sscn_s = time.perf_counter() - t0
        scnt = _counts()
        _ls_replayed("figure2 news20-like", scnt, sscn_its=sscn.it,
                     exact=False)
        sscn_ts = curves["SSCN (m=1000)"]["ts"]
        data = rf.merge_json(
            f"{tmp}/{name}.json", name, "h100-fp32", curves,
            rf.leg_f_best(loss, curves),
            rf.leg_meta(name, A, 50, "h100-fp32", None))
        gaps = _final_gaps_ok("figure2 news20-like", data)
        print(f"figure2 news20-like: GramKrylov m=10 {kry.it} iterations "
              f"certified in {kry_s:.3f} s, symv launches {cnt['symv']}, "
              f"graph replays {cnt['graph_replays']}; "
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
                         kmatvec_calls=cnt["kmatvec_calls"],
                         graph_replays=cnt["graph_replays"],
                         subproblem_launches=cnt["subproblem"],
                         eigh_launches=scnt["eigh"],
                         secular_launches=scnt["secular"],
                         fold_launches=cnt["fold"] + scnt["fold"])
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
    from krylov_crn_tpu_torch.ops.gram import (
        build_K_device,
        k_matvec,
        syrk_split_P,
    )
    from krylov_crn_tpu_torch.ops.matvec import matvec, matvec_plain
    from krylov_crn_tpu_torch.ops.symv import symv
    from krylov_crn_tpu_torch.parallel.mesh import all_gather_rows
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
    build_K_device.panels = syrk_split_P.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg.init_run(x0, 42)
    alg.initialized = True
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k_build = dict(panels=build_K_device.panels,
                   split_panels=syrk_split_P.cuda_calls)
    matvec.launches = symv.launches = 0
    k_matvec.band_cuda_calls = k_matvec.cuda_calls = 0
    gram_krylov_step.graph_replays = 0
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
        graph_replays=gram_krylov_step.graph_replays,
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
    # the whole K from the bands (each rank built it whole and kept its
    # rows), after the race's and the step's counts were read
    K_all = all_gather_rows(mesh, K)
    out["k_build"] = dict(k_build,
                          bitwise_symmetric=bool(K_all.equal(K_all.T)))
    del alg, K, K_all, loss
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
          f"launches {race['symv_launches']}; graph replays "
          f"{race['graph_replays']} (the sharded step runs eagerly)")
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
                and rc["symv_launches"] == rc["whole_calls"] == 0
                and rc["graph_replays"] == 0):
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
        _split_rec_ok(f"mesh rank {r['rank']}", r["k_build"],
                      main_rec["k_build"]["want"])
    out.update(race=race, step_counts=r0["step_counts"], crossing_it=cross,
               k_build=[r["k_build"] for r in ranks],
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


# bench.py's output keys, top level and per race
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "news20", "rcv1",
              "kmatvec_gbps", "kmatvec_roofline_frac", "symv_ms",
              "symv_effective_gbps", "coo_hvp_mnnz_per_s", "gap_target")
BENCH_RACE_KEYS = ("problem", "build_s", "f_star", "ours_gap_reached",
                   "ours_s", "ours_attempts_s", "ours_final_gap")
OUR_ITS = 48  # the bench's race length (krylov_crn_tpu_torch.bench)
BENCH_REPS = 2
BENCH_TIMEOUT = 600.0
BENCH_SYMV_REL = 0.10  # its symv_ms against phase kernel@K's median


def phase_bench(card, symv_ms, panels):
    """The port's bench as a user runs it, in a process of its own:
    ``python -m krylov_crn_tpu_torch.bench``. Its last line must hold
    bench.py's keys; both races reach a certified 1e-8 gap within 48
    iterations, every K-matvec through SYMV, every K build panel through
    the split (``panels``: each race's panels per build, from phases main
    and news20; the bench raises on a K that is not bitwise symmetric);
    no reference leg; the card's line; its SYMV median within 10% of
    ``symv_ms`` (phase kernel@K's at n_pad 20480)."""
    import os
    import subprocess

    t0 = time.perf_counter()
    # stderr (each attempt's seconds) goes straight to this run's log
    proc = subprocess.run(
        [sys.executable, "-m", "krylov_crn_tpu_torch.bench", "--reps",
         str(BENCH_REPS)], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, text=True, timeout=BENCH_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"bench: exit code {proc.returncode}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"bench ({seconds:.1f} s, --reps {BENCH_REPS}): {line}")
    out = json.loads(line)
    missing = [k for k in BENCH_KEYS if k not in out] + [
        f"{r}.{k}" for r in ("news20", "rcv1") for k in BENCH_RACE_KEYS
        if k not in out.get(r, {})]
    if missing:
        raise RuntimeError(f"bench: keys missing {missing}")
    launches = 0
    for r in ("news20", "rcv1"):
        res, sl = out[r], out[r]["symv_launches"]
        print(f"bench {r}: {res['ours_s']} s to the gap (build "
              f"{res['build_s']} s, attempts {res['ours_attempts_s']}), "
              f"crossing at iteration {res['ours_crossing_it']}, final gap "
              f"{res['ours_final_gap']}; symv launches {sl}; graph replays "
              f"{res['graph_replays']}")
        if not res["graph_replays"] >= BENCH_REPS * OUR_ITS:
            raise RuntimeError(f"bench {r}: {res['graph_replays']} graph "
                               f"replays in {BENCH_REPS} attempts")
        if not (res["ours_gap_reached"] and res["ours_crossing_it"] <= 48):
            raise RuntimeError(f"bench {r}: no certified {GAP} gap within "
                               "48 iterations")
        if not sl["launches"] == sl["k_matvec_calls"] > 0:
            raise RuntimeError(f"bench {r}: K-matvecs bypassed the kernel: "
                               f"{sl}")
        # the bench raises on a built K that is not bitwise symmetric
        _split_rec_ok(f"bench {r}", dict(res["k_build"],
                                         bitwise_symmetric=True),
                      BENCH_REPS * panels[r])
        launches += sl["launches"]
    if out["vs_baseline"] is not None or out["card"] != card:
        raise RuntimeError(f"bench: vs_baseline {out['vs_baseline']}, card "
                           f"{out['card']!r} (this card: {card!r})")
    rel = abs(out["symv_ms"] - symv_ms) / symv_ms
    print(f"bench: symv {out['symv_ms']} ms against {symv_ms:.4f} ms in "
          f"phase kernel@K ({rel:.1%} apart)")
    if not rel <= BENCH_SYMV_REL:
        raise RuntimeError(f"bench: symv_ms {out['symv_ms']} is {rel:.1%} "
                           f"from kernel@K's {symv_ms:.4f} ms")
    return dict(out, seconds=seconds, launches=launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record to this JSON")
    args = ap.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    record = {"card": card, "build_s": phase_build(),
              "fold": phase_fold(dev)}
    _plain_folds_refuse_the_card()
    record["kernel"] = phase_kernel(dev)
    alg, record["main"] = phase_main(dev)
    record["fused"] = phase_fused(dev, alg)
    record["dspace_fused"] = phase_dspace_fused(dev, alg)
    record["eigh"] = phase_eigh(dev)
    record["ls_fused"] = phase_ls_fused(dev)
    record["kernel_on_K"] = phase_kernel_on_K(dev, alg.gd.K)
    record["bf16_head"] = {"rcv1-like": phase_bf16_head(
        dev, "main", alg, record["main"], BF16_HEAD_ITS["rcv1-like"])}
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
    record["bf16_head"]["news20-like"] = phase_bf16_head(
        dev, "news20", news20_alg, record["news20"],
        BF16_HEAD_ITS["news20-like"])
    record["figure2"] = phase_figure2(news20_alg)
    del news20_alg
    torch.cuda.empty_cache()
    record["skew"] = phase_skew(dev)
    torch.cuda.empty_cache()
    record["splitk"] = phase_splitk(
        card, {"rcv1-like": record["main"]["k_build"]["want"],
               "news20-like": record["news20"]["k_build"]["want"]})
    torch.cuda.empty_cache()
    record["stress1m"] = phase_stress1m(dev, card)
    torch.cuda.empty_cache()
    record["mesh"] = phase_mesh(card, record["main"], record["sparse"],
                                record["sscn"])
    record["bench"] = phase_bench(
        card, record["kernel_on_K"]["ms"],
        {"rcv1": record["main"]["k_build"]["want"],
         "news20": record["news20"]["k_build"]["want"]})
    record["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: all phases in {record['seconds']:.1f} s")
    kk, mv, fig = record["kernel_on_K"], record["matvec"], record["figure2"]
    fold = record["fold"]["times"]["dot2 21x20480"]
    eig, sec = record["eigh"]["n"][300], record["eigh"]["secular"][300]
    ls_runs = (record["dense"], record["cli_gram"], record["sscn"],
               record["cli_dense"], fig["w8a-like"], fig["news20-like"])
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
                     + fig["news20-like"]["launches"]
                     + record["bench"]["launches"]
                     + sum(h["symv_launches"]
                           for h in record["bf16_head"].values())),
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
                      record["mesh"]["band_max_abs_err"])] + [
        # the bf16 path at the shape of each Gram problem's K, launched by
        # the head's Lanczos products (phase bf16_head)
        matvec_record(f"matvec_bf16_K_{n}x{n}", f"{n}x{n}_bfloat16",
                      record["bf16_head"][name]["lr_launches"],
                      record["bf16_head"][name]["max_abs_err"])
        for name, n in (("rcv1-like", 20480), ("news20-like", 20224))] + [{
        # not a TPU kernel's counterpart: the JAX step's eigh and vmapped
        # Newton, which XLA runs on the device; max_abs_err over theta and
        # the finite lambdas against the plain version on 48 steps' inputs,
        # timed on the 48th step's
        "name": "tridiag_secular", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/subproblem.cu",
        "replaces": "krylov_crn_tpu/ops/subproblem.py:48",
        "launches": (record["main"]["subproblem_launches"]
                     + record["news20"]["subproblem_launches"]
                     + record["cli_gram"]["subproblem_launches"]
                     + fig["news20-like"]["subproblem_launches"]
                     + sum(h["subproblem_launches"]
                           for h in record["bf16_head"].values())
                     + record["dense"]["subproblem_launches"]
                     + record["sparse"]["subproblem_launches"]
                     + record["cli_dense"]["subproblem_launches"]
                     + fig["w8a-like"]["subproblem_launches"]),
        "max_abs_err": record["fused"]["worst"]["abs_err"],
        "ms": record["fused"]["ms"], "plain_ms": record["fused"]["plain_ms"],
        "bound_ms": record["fused"]["bound_ms"],
        "bound_by": record["fused"]["bound_by"],
        "library_ms": record["fused"]["eigh_ms"]}] + [{
        # not TPU kernels' counterparts either: the JAX CRN "full" and SSCN
        # steps' jnp.linalg.eigh and vmapped secular_newton, which XLA
        # runs on the device; launched by the CRN full and SSCN steps of
        # phases dense, cli_gram, sscn, cli_dense and figure2; timed at
        # CRN full's n = 300 on w8a-like (phase eigh has 10, 500 and
        # 1000); max_abs_err the worst over phase eigh's sizes
        "name": "sym_eigh", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/eigh.cu",
        "replaces": "krylov_crn_tpu/solvers/crn.py:105",
        "launches": sum(r["eigh_launches"] for r in ls_runs),
        "max_abs_err": record["eigh"]["max_abs_err"],
        "ms": eig["ms"], "plain_ms": eig["plain_ms"],
        "bound_ms": eig["bound_ms"], "bound_by": eig["bound_by"],
        "library_ms": eig["library_ms"]}, {
        "name": "eig_secular", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/subproblem.cu",
        "replaces": "krylov_crn_tpu/ops/subproblem.py:58",
        "launches": sum(r["secular_launches"] for r in ls_runs),
        "max_abs_err": max(r["max_abs_err"] for r in
                           record["eigh"]["secular"].values()),
        "ms": sec["ms"],
        "plain_ms": sec["plain_ms"], "bound_ms": sec["bound_ms"],
        "bound_by": sec["bound_by"], "library_ms": None}, {
        # not a TPU kernel's counterpart: the JAX package's folds are XLA
        # fusions; launched by the compensated folds of the main-path runs
        # (counters zeroed before each); timed at the Gram candidates'
        # (21, 20480) dot2; max_abs_err the largest difference from its
        # plain version over phase fold's cases
        "name": "fold", "route": "cuda",
        "source": "krylov_crn_tpu_torch/csrc/fold.cu",
        "replaces": "krylov_crn_tpu/ops/math.py:sum2",
        "launches": sum(r["fold_launches"] for r in (
            record["main"], record["news20"], record["rollback"],
            record["dense"], record["sparse"], record["cli_gram"],
            record["sscn"], record["cli_dense"], fig["w8a-like"],
            fig["news20-like"], *record["bf16_head"].values())),
        "max_abs_err": record["fold"]["max_abs_err"],
        "ms": fold["ms"], "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"], "bound_by": fold["bound_by"],
        "library_ms": fold["library_ms"]}]}
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
