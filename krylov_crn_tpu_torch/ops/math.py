"""Elementwise math + compensated (two-float) accumulation.

Port of ``krylov_crn_tpu/ops/math.py``. Sums and dot products are carried
as two-float pairs (hi, lo), with hi = fl(sum) and lo the rounding residue
(Knuth two-sum, Dekker two-product: error-free transformations). A pair
read on the host as float64(hi) + float64(lo) recovers about twice the
working precision, which lets the fp32 solver resolve 1e-9 suboptimality
gaps without fp64 bulk arithmetic.

The error-free transforms assume that no FMA contraction and no
reassociation happen between their operations. Eager PyTorch runs each
operator as its own kernel, so that holds here. On a card the folds
(``sum2``, ``dot2``) have one CUDA home, ``csrc/fold.cu``, one launch a
call (``fold``), built with ``--fmad=false --prec-div=true
--prec-sqrt=true --ftz=false`` (``ops/_kernels.KERNEL_FLAGS``): every
operation there rounds on its own, and ``_lane_fold`` is its plain
version, bit for bit. Never put these transforms into a CUDA
source built with the default ``--fmad=true``, nor under
``torch.compile`` (on the CPU, inductor keeps the eager bits of
``two_sum``, ``_split``, ``_two_prod``, ``sum2`` and ``dot2_plain``, whose
every sum is written out in order: tests/test_torch_compile_folds.py).

Every reduction works on the last axis and broadcasts over leading
(batch) axes, so the 21 line-search candidates fold in one pass.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "logsig", "sigmoid", "div_n", "over_n",
    "two_sum", "sum2", "dot2", "dot2_plain", "fold", "LANES",
    "accum_sum", "accum_dot", "accum_sum_pair",
    "pair_diff", "ls_accept", "reg_clamp",
]


def logsig(x):
    """log(sigmoid(x)) = -softplus(-x), numerically stable across the line."""
    return F.logsigmoid(x)


def sigmoid(x):
    return torch.sigmoid(x)


def softplus(x):
    """log(1 + exp(x)) exactly (``F.softplus`` returns x above its
    threshold of 20, which breaks fp64 parity with ``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def div_n(t, n):
    """t / n, divided truly on every device (the d-space value, whose
    reading is held against f*). PyTorch's CUDA division takes a Python
    number (or a 0-d CPU tensor) as a scalar and multiplies by its rounded
    reciprocal, which scales every result by fl(1/n) * n (2e-8 relative
    at n = 49,749). The divisor is a 0-d tensor of t's dtype on t's
    device."""
    return t / torch.full((), n, dtype=t.dtype, device=t.device)


def over_n(t, n):
    """t / n in the JAX package's fp32 arithmetic, the same bits on every
    device: an fp32 t times fl32(1/n). The JAX package divides by n inside
    jit, where n is static (``GramData.n``, the sparse matrices' shapes),
    and XLA folds a division by a compile-time constant into that product
    on every backend; eager PyTorch divides truly on the CPU and takes the
    product on a card (for a Python divisor), so ``t / n`` gave two
    results. Other dtypes divide truly (``div_n``), as the host's exact
    fp64 values that the fp64 runs are held against do."""
    if t.dtype != torch.float32:
        return div_n(t, n)
    return t * float(np.reciprocal(np.float32(n)))


# --------------------- error-free transformations ---------------------

def two_sum(a, b):
    """Knuth two-sum: s = fl(a+b) and the exact rounding error e, such
    that a + b == s + e exactly (branch-free, any sign ordering)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split of a float into hi+lo halves with non-overlapping
    mantissas (fp32: 24 = 12+12 bits, splitter 2^12+1; fp64: 2^27+1)."""
    splitter = 134217729.0 if a.dtype == torch.float64 else 4097.0
    c = splitter * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker two-product: p = fl(a*b) and the exact error e
    (a * b == p + e). No FMA assumed."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


LANES = 1024  # the folds' lanes; csrc/fold.cu: a block's threads


def _lane_rows(x, lanes):
    """The last axis as ``(..., steps, lanes)`` rows, zero-padded."""
    n = x.shape[-1]
    steps = max(-(-n // lanes), 1)
    pad = steps * lanes - n
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], steps, lanes)


def _lane_fold(x, err=None, lanes=LANES):
    """Compensated fold of the last axis into per-lane (hi, lo) pairs by a
    sequential pass over rows of ``lanes`` elements, then a binary-tree
    pair merge across lanes. Error O(n * eps^2). Same fold order as the
    JAX package (a row pass starting from zero, then halving merges); the
    first row is taken as is, which is what two_sum(0, row) returns.
    ``err`` (x's shape), if given, holds errors of x's values (dot2's
    product errors): each row's go into lo after that row's two_sum
    error, the first row's as lo's start."""
    xf = _lane_rows(x, lanes)
    ef = None if err is None else _lane_rows(err, lanes)
    hi = xf[..., 0, :]
    lo = torch.zeros_like(hi) if ef is None else ef[..., 0, :]
    for r in range(1, xf.shape[-2]):
        hi, e = two_sum(hi, xf[..., r, :])
        lo = lo + e
        if ef is not None:
            lo = lo + ef[..., r, :]
    # tree-merge the lanes, propagating the exact merge errors into lo
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        hi2 = hi.reshape(*hi.shape[:-1], 2, h)
        lo2 = lo.reshape(*lo.shape[:-1], 2, h)
        hi, e = two_sum(hi2[..., 0, :], hi2[..., 1, :])
        lo = lo2[..., 0, :] + lo2[..., 1, :] + e
    return hi[..., 0], lo[..., 0]


def sum2(x):
    """Compensated sum over the last axis -> (hi, lo) pair in x.dtype:
    one launch of ``fold`` for a CUDA tensor, ``_lane_fold`` (the same
    bits) on the CPU."""
    if x.is_cuda:
        return fold(x)
    return _lane_fold(x)


def dot2_plain(x, y):
    """``dot2`` as ``csrc/fold.cu`` computes it, in plain PyTorch, bit for
    bit: the products' hi parts folded by ``_lane_fold``, each row's
    product errors added into lo after its two_sum errors."""
    p, e = _two_prod(x, y)
    return _lane_fold(p, e)


def dot2(x, y):
    """Compensated <x, y> over the last axis -> (hi, lo) pair
    (Ogita-Rump-Oishi dot2): exact per-element products via Dekker
    two-product, compensated sum of the product hi parts, plain sum of the
    (already O(eps)-sized) product errors folded into lo. One launch of
    ``fold`` for CUDA tensors, ``dot2_plain`` (the same bits) on the
    CPU."""
    if x.is_cuda or y.is_cuda:
        return fold(x, y)
    return dot2_plain(x, y)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("fold")
        row = [ctypes.c_void_p, ctypes.c_longlong]
        for fn in (lib.sum2_f32, lib.sum2_f64):
            fn.argtypes = row + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        for fn in (lib.dot2_f32, lib.dot2_f64):
            fn.argtypes = row * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        lib.fold_lanes.argtypes = []
        lib.fold_lanes.restype = ctypes.c_int
        if lib.fold_lanes() != LANES:
            raise RuntimeError("csrc/fold.cu's lanes disagree with LANES")
        _lib = lib
    return _lib


def _operand_rows(t, lead, batch, n):
    """``t`` (..., n) as rows for the kernel: (tensor, row stride), the
    stride 0 where one row serves the whole batch."""
    if math.prod(t.shape[:-1]) == 1:
        t = t.reshape(n)
        return (t if t.stride(-1) == 1 else t.contiguous()), 0
    if t.shape[:-1] != lead:
        t = t.expand(*lead, n)
    t = t.reshape(batch, n)
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def fold(x, y=None):
    """``sum2(x)``, or with ``y`` ``dot2(x, y)``, over the last axis of
    CUDA tensors (fp32 or fp64, leading axes broadcast): one launch of
    ``csrc/fold.cu``, one block a row of the batch, which reads nothing
    back to the host and allocates the (hi, lo) outputs alone (and a
    contiguous copy of an operand strided along its last axis).
    ``fold.launches`` counts the launches."""
    ts = (x,) if y is None else (x, y)
    dev, dt = x.device, x.dtype
    for t in ts:
        if not (t.is_cuda and t.device == dev):
            raise ValueError(f"fold: every operand on x's CUDA device "
                             f"({dev}), got {t.device}")
        if t.dtype != dt or dt not in (torch.float32, torch.float64):
            raise TypeError(f"fold: fp32 or fp64 operands of one dtype, got "
                            f"{[u.dtype for u in ts]}")
        if t.dim() < 1 or t.shape[-1] != x.shape[-1]:
            raise ValueError(f"fold: operands of one last axis, got "
                             f"{[tuple(u.shape) for u in ts]}")
    n = x.shape[-1]
    if n >= 2 ** 31:
        raise ValueError(f"fold: {n} values a row (at most 2**31 - 1)")
    lead = torch.broadcast_shapes(*(t.shape[:-1] for t in ts))
    batch = math.prod(lead)
    hi = torch.empty(lead, dtype=dt, device=dev)
    lo = torch.empty(lead, dtype=dt, device=dev)
    if batch == 0:
        return hi, lo
    rows = [_operand_rows(t, lead, batch, n) for t in ts]
    lib = _library()
    f32 = dt == torch.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [a for t, stride in rows for a in (t.data_ptr(), stride)]
        fn = ((lib.sum2_f32 if f32 else lib.sum2_f64) if y is None
              else (lib.dot2_f32 if f32 else lib.dot2_f64))
        err = fn(*args, n, batch, hi.data_ptr(), lo.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fold kernel launch failed: CUDA error {err}")
    fold.launches += 1
    return hi, lo


fold.launches = 0


def pair_diff(ahi, alo, bhi, blo):
    """(a - b) for two pairs, accurate when a and b are close: the hi
    difference is exact by Sterbenz when within 2x of each other."""
    s, e = two_sum(ahi, -bhi)
    return s + (e + (alo - blo))


def reg_clamp(reg, ceil: float = 1e6):
    """Ceiling for the committed cubic regularization coefficient (see
    ``krylov_crn_tpu/ops/math.py:reg_clamp`` for the all-reject episode
    this guards against)."""
    return torch.clamp(reg, max=ceil)


def ls_accept(vhi, vlo, fhi, flo, model_dec):
    """Backtracking accept test on two-float values: sufficient decrease
    at full pair resolution, or non-increase once the model decrease is
    below one ulp of f. NaN fails both clauses."""
    gap = pair_diff(vhi, vlo, fhi, flo)
    ulp = torch.finfo(vhi.dtype).eps * torch.abs(fhi)
    return (gap <= -model_dec) | ((model_dec <= ulp) & (gap <= 0))


# --------------------------- accum dispatch ---------------------------

def accum_sum(x, accum_dtype):
    """Sum over the last axis; compensated (collapsed pair) when the accum
    dtype equals the storage dtype, else an upcast sum."""
    if accum_dtype == x.dtype:
        hi, lo = sum2(x)
        return hi + lo
    return x.to(accum_dtype).sum(-1)


def accum_dot(x, y, accum_dtype):
    """<x, y> over the last axis with compensated (or upcast) accumulation."""
    if accum_dtype == x.dtype:
        hi, lo = dot2(x, y)
        return hi + lo
    return (x.to(accum_dtype) * y.to(accum_dtype)).sum(-1)


def accum_sum_pair(x, accum_dtype):
    """Sum -> (hi, lo) pair: compensated in-dtype when accum == storage,
    else a plain upcast sum with lo = 0."""
    if accum_dtype == x.dtype:
        return sum2(x)
    s = x.to(accum_dtype).sum(-1)
    return s, torch.zeros_like(s)
