"""The split-K bf16 Gram build against a plain fp32 SGEMM on one card.

    python -m krylov_crn_tpu_torch.tools.measure_splitk [--dataset rcv1-like]

Port of ``tools/measure_splitk.py``. Measures, with the card's name and
power limit in the output:

* accuracy on the dataset's first 4,096 rows: the split build
  (``ops/gram.build_K_device``, three bf16 slices, a bf16 product with
  fp32 output per panel) and a direct fp32 SGEMM of the densified rows
  (TF32 off; the JAX tool's ``highest6``), each against the host's fp64
  Gram: the elementwise max of |K - K64| / sqrt(K64_ii K64_jj) and the
  K-matvec's relative error on a seeded normal vector. ``split`` is the
  build's own contraction order (``gram.syrk_split_P``: the small blocks,
  then the big b1 b1^T block in runs of ``gram.SPLIT_CHUNK`` columns); on
  a card two others are measured beside it, summed here from the same
  operands (``ORDERS``): ``split_small_first`` (the big block in one run)
  and ``split_one_call`` (one product of depth 4cb, the JAX package's);
* the panel step at (n_pad x 2048), split (each order) against fp32
  SGEMM, chained as the JAX tool chains it (K += B B^T, then
  B += K[:, :cb] * 1e-30, so each step reads the previous one's K):
  median ms per step over CUDA events, TFLOP/s of the 2 n_pad^2 cb flops
  of B B^T, and each variant's bound, the larger of its flops at the data
  sheet's peak (989 TFLOP/s bf16 dense for the split's 8 n_pad^2 cb,
  67 TFLOP/s fp32 for SGEMM) and K read and written once plus B read once
  at 3.35 TB/s; on this dense normal panel also each variant's B B^T (its
  first 1,024 rows) against fp64, max |error| / max |B B^T|;
* the card's split P against ``syrk_split_P_plain`` on the card, on the
  same panel (``split_vs_plain``): both sum the same exact fp32 products,
  in another order. Two fp32 sums of 4cb terms in any orders lie at most
  2 * 4cb * 2^-23 * (|X| |Y|^T) apart, rounded or truncated; a P merely
  rounded to bf16 meets that bound too, so the gate is ``ORDER_GATE`` of
  it, and the same comparison of P rounded to bf16 is reported as the
  control that has to exceed the gate;
* the whole ``build_K_device`` on rcv1-like and news20-like: seconds (the
  bf16 product warmed once at the panel's shape first, so a process's
  one-time cuBLAS setup is not in them), panels, panels whose bf16
  products ran on the card and whether K is bitwise symmetric.

Prints one JSON object; needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

__all__ = ["measure", "main", "split_vs_plain", "ACC_ROWS", "PANEL_COLS",
           "BF16_TFLOPS", "FP32_TFLOPS", "ORDER_GATE", "ORDERS"]

ACC_ROWS = 4096  # the host fp64 Gram of all ~20k rows would be 3.2 GB
PANEL_COLS = 2048  # the build's panel width
BF16_TFLOPS = 989.0  # H100 SXM data sheet, dense tensor-core bf16
FP32_TFLOPS = 67.0  # H100 SXM data sheet, fp32 outside the tensor cores
EPS_ORDER = 2.0 ** -23  # one fp32 ulp at 1: rounding or truncating sums
# the card's P against its plain version, as a share of the any-order
# bound: the sound product read 5.85e-3 of it (20480 x 2048 normal
# panel, H100), a P rounded to bf16 reads ~1 and more
ORDER_GATE = 0.05
DENSE_ROWS = 1024  # rows of the dense panel's B B^T held against fp64


def _P_small_first(X, Y, cb, P):
    """The small blocks into P, then the big b1 b1^T block in one run."""
    import torch

    torch.mm(X[:, cb:], Y[:, cb:].T, out_dtype=torch.float32, out=P)
    return torch.addmm(P, X[:, :cb], Y[:, :cb].T, out_dtype=torch.float32,
                       out=P)


def _P_one_call(X, Y, cb, P):
    """One product of depth 4cb, the JAX package's ``dot_general``."""
    import torch

    return torch.mm(X, Y.T, out_dtype=torch.float32, out=P)


# the split's contraction orders other than the build's, P = X Y^T of
# gram._split_operands' X and Y (bf16 products, so a card's only)
ORDERS = {"split_small_first": _P_small_first,
          "split_one_call": _P_one_call}


def _order_K(As, n_pad, dev, P_of):
    """K of ``As``'s rows through the split with each panel's P summed by
    ``P_of``: the active columns in panels of PANEL_COLS, as
    ``build_K_device`` cuts them, and K += P + P^T."""
    import torch

    from krylov_crn_tpu_torch.ops.gram import _split_operands

    active = np.flatnonzero(np.diff(As.tocsc().indptr))
    d = len(active)
    cb = min(-(-d // 512) * 512, PANEL_COLS)
    D = torch.zeros((n_pad, -(-d // cb) * cb), device=dev)
    D[:As.shape[0], :d] = torch.from_numpy(
        As[:, active].toarray().astype(np.float32))
    X = torch.empty((n_pad, 4 * cb), dtype=torch.bfloat16, device=dev)
    Y = torch.empty_like(X)
    K = torch.zeros((n_pad, n_pad), device=dev)
    P = torch.empty_like(K)
    for a in range(0, D.shape[1], cb):
        _split_operands(D[:, a:a + cb].contiguous(), X, Y)
        P = P_of(X, Y, cb, P)
        K.add_(P + P.T)
    return K


def _accuracy(A, dev):
    """Split build (and, on a card, the other ORDERS) and direct SGEMM of
    A's first ACC_ROWS rows against the host fp64 Gram."""
    import torch

    from krylov_crn_tpu_torch.ops.gram import build_K_device, pad_rows

    ns = min(ACC_ROWS, A.shape[0])
    As = A[:ns]
    K64 = (As.astype(np.float64) @ As.T.astype(np.float64)).toarray()
    w = np.random.default_rng(0).standard_normal(ns)
    ref_mv = K64 @ w
    scale = np.sqrt(np.outer(np.diag(K64), np.diag(K64))) + 1e-30
    Bs = torch.from_numpy(As.toarray().astype(np.float32)).to(dev)

    builds = {"split": lambda: build_K_device(As, pad_rows(ns), np.float32,
                                              dev)}
    if dev.type == "cuda":
        builds.update({tag: (lambda f=P_of: _order_K(As, pad_rows(ns), dev,
                                                      f))
                       for tag, P_of in ORDERS.items()})
    builds["sgemm_fp32"] = lambda: Bs @ Bs.T
    out = {}
    for tag, build in builds.items():
        Kh = build()[:ns, :ns].double().cpu().numpy()
        out[tag] = {
            "elem_max_rel": float((np.abs(Kh - K64) / scale).max()),
            "matvec_rel": float(np.linalg.norm(Kh @ w - ref_mv)
                                / np.linalg.norm(ref_mv)),
        }
    return out


def split_vs_plain(B):
    """The card's split P of panel ``B`` against ``syrk_split_P_plain``
    on the same device: the max absolute difference, its max share of the
    any-order bound 2 * 4cb * 2^-23 * (|X| |Y|^T) (the gate holds it to
    ORDER_GATE), and the same share for P rounded to bf16, the control
    that the gate has to refuse."""
    from krylov_crn_tpu_torch.ops.gram import (
        _split_operands,
        syrk_split_P,
        syrk_split_P_plain,
    )

    P = syrk_split_P(B)
    Pp = syrk_split_P_plain(B)
    X, Y = _split_operands(B)
    cb4 = X.shape[1]
    bound = (2 * cb4 * EPS_ORDER) * (X.abs().float() @ Y.abs().float().T)
    bound.clamp_min_(1e-30)
    share = float(((P - Pp).abs_().div_(bound)).max())
    control = float(((P.bfloat16().float() - Pp).abs_().div_(bound)).max())
    return {"max_abs_diff": float((P - Pp).abs().max()),
            "max_rel_to_order_bound": share,
            "bf16_out_rel_to_order_bound": control,
            "gate": ORDER_GATE,
            "tolerance": f"{ORDER_GATE} * 2 * 4cb * 2^-23 * (|X| |Y|^T), "
                         f"4cb = {cb4}"}


def _step_ms(step, K, B, reps):
    """Median ms of ``step(K, B)`` over ``reps`` chained calls, each
    between two CUDA events, after two warm-up calls."""
    import torch

    for _ in range(2):
        step(K, B)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        step(K, B)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _panel(n_pad, dev, reps):
    """The panel step, split (each order) against SGEMM, and the card's
    split P against its plain version, at (n_pad x PANEL_COLS)."""
    import torch

    from krylov_crn_tpu_torch.ops.gram import (
        _panel_accum,
        _split_operands,
        syrk_split_P,
    )
    from krylov_crn_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    cb = PANEL_COLS
    gen = torch.Generator(device=dev).manual_seed(0)
    B0 = torch.randn((n_pad, cb), generator=gen, device=dev)

    vs_plain = split_vs_plain(B0)
    torch.cuda.empty_cache()

    X = torch.empty((n_pad, 4 * cb), dtype=torch.bfloat16, device=dev)
    Y = torch.empty_like(X)
    P = torch.empty((n_pad, n_pad), device=dev)
    S = torch.empty_like(P)
    bufs = (X, Y, P, S)

    def split_step(K, B):
        _panel_accum(K, B, bufs)
        B.add_(K[:, :cb], alpha=1e-30)

    def order_step(P_of):
        def step(K, B):
            _split_operands(B, X, Y)
            K.add_(torch.add(P_of(X, Y, cb, P), P.T, out=S))
            B.add_(K[:, :cb], alpha=1e-30)
        return step

    def sgemm_step(K, B):
        K.addmm_(B, B.T)
        B.add_(K[:, :cb], alpha=1e-30)

    steps = {"split": (split_step, BF16_TFLOPS, 4)}
    steps.update({tag: (order_step(P_of), BF16_TFLOPS, 4)
                  for tag, P_of in ORDERS.items()})
    steps["sgemm_fp32"] = (sgemm_step, FP32_TFLOPS, 1)

    # B B^T's first DENSE_ROWS rows against fp64 on this dense panel
    ref = B0[:DENSE_ROWS].double() @ B0.double().T
    dense = {"sgemm_fp32": B0[:DENSE_ROWS] @ B0.T}
    Ps = {"split": syrk_split_P(B0)}
    _split_operands(B0, X, Y)
    Ps.update({tag: P_of(X, Y, cb, torch.empty_like(P))
               for tag, P_of in ORDERS.items()})
    for tag, Pt in Ps.items():
        dense[tag] = Pt[:DENSE_ROWS] + Pt[:, :DENSE_ROWS].T
    del Ps, Pt
    dense = {tag: float((Bt.double() - ref).abs().max() / ref.abs().max())
             for tag, Bt in dense.items()}
    del ref
    torch.cuda.empty_cache()

    flops = 2.0 * n_pad * n_pad * cb
    nbytes = (2 * n_pad * n_pad + n_pad * cb) * 4
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"n_pad": n_pad, "cb": cb, "tflop_B_Bt": flops / 1e12}
    for tag, (step, peak, mult) in steps.items():
        K = torch.zeros((n_pad, n_pad), device=dev)
        ms = _step_ms(step, K, B0.clone(), reps)
        op_ms = mult * flops / (peak * 1e12) * 1e3
        out[tag] = {"ms": ms, "tflops": flops / ms / 1e9,
                    "dense_elem_rel": dense[tag],
                    "bound_ms": max(op_ms, mem_ms),
                    "bound_by": "operations" if op_ms >= mem_ms else "bytes",
                    "peak_tflops": peak}
        del K
        torch.cuda.empty_cache()
    out["speedup"] = out["sgemm_fp32"]["ms"] / out["split"]["ms"]
    return out, vs_plain


def _build(name, dev):
    """The whole device K build of a stand-in, timed on the host clock
    between two synchronizes, after one untimed split product at the
    build's panel shape (the process's first bf16 product carries cuBLAS's
    one-time setup)."""
    import torch

    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import (
        build_K_device,
        pad_rows,
        syrk_split_P,
    )

    A, _ = synthetic_logreg(name, seed=0)
    n_pad = pad_rows(A.shape[0])
    syrk_split_P(torch.zeros((n_pad, PANEL_COLS), device=dev))
    torch.cuda.empty_cache()
    build_K_device.panels = syrk_split_P.cuda_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K = build_K_device(A, n_pad, np.float32, dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"build_s": seconds, "n_pad": n_pad,
           "panels": build_K_device.panels,
           "split_panels": syrk_split_P.cuda_calls,
           "bitwise_symmetric": bool(torch.equal(K, K.T))}
    del K
    torch.cuda.empty_cache()
    return A, out


def measure(dataset="rcv1-like", builds=("rcv1-like", "news20-like"),
            reps=10):
    import torch

    from krylov_crn_tpu_torch.config import resolve_device
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
    from krylov_crn_tpu_torch.ops.gram import pad_rows
    from krylov_crn_tpu_torch.utils.profiling import card_description

    dev = resolve_device(None)
    out = {"dataset": dataset, "card": card_description(),
           "device": torch.cuda.get_device_name(0)}
    A = None
    out["build"] = {}
    for name in builds:
        A_name, out["build"][name] = _build(name, dev)
        if name == dataset:
            A = A_name
    if A is None:
        A, _ = synthetic_logreg(dataset, seed=0)
    out["accuracy"] = _accuracy(A, dev)
    out["panel_gemm"], out["split_vs_plain"] = _panel(
        pad_rows(A.shape[0]), dev, reps)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="rcv1-like")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.dataset, reps=args.reps)))


if __name__ == "__main__":
    main()
