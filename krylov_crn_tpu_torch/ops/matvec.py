"""Dense matrix-vector product y = K @ x with fp32 accumulation.

``matvec`` launches the hand-written CUDA kernel ``csrc/matvec.cu`` for
tensors on a card: K (n, m) in fp32 or bf16 with any leading dimension,
x and y fp32, a deterministic two-pass column-split scheme (see the
source's header). It replaces the Pallas TPU kernel
``tools/measure_matvec.py:_matvec_kernel``, and it carries the d-space
dense branch of ``ops/spmv.py`` (``A x`` on the dense copy of A, ``A^T z``
on the dense copy of A^T).

``matvec_plain`` is the same function in plain PyTorch. ``matvec`` takes
it only for tensors that lie on the CPU; a tensor on a card goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["matvec", "matvec_plain", "split_plan"]

UNROLL = 4  # csrc/matvec.cu's 16-byte loads per lane in one warp pass
TARGET_WARPS = 8192  # ~132 SMs x 64 resident warps

_lib = None


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("matvec")
        args = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.matvec_f32, lib.matvec_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_plan(n: int, m: int, itemsize: int) -> tuple[int, int]:
    """(splits, width): the column splits the kernel runs for an (n, m)
    matrix, a function of the shape only. Enough (row, split) warps to
    fill the card when n is small, one split when n is large; split
    boundaries fall on whole unrolled warp passes."""
    def cdiv(a, b):
        return -(-a // b)

    chunk = UNROLL * 32 * (16 // itemsize)
    s = max(min(cdiv(TARGET_WARPS, n), cdiv(m, chunk)), 1)
    width = cdiv(cdiv(m, s), chunk) * chunk
    return cdiv(m, width), width


def matvec_plain(K, x):
    """y = K @ x in plain PyTorch, with K upcast to x's dtype (a bf16 K
    against an fp32 x is K.float() @ x; fp64 stays fp64)."""
    return K.to(torch.promote_types(K.dtype, x.dtype)) @ x


def _check(K, x):
    if not (K.is_cuda and x.is_cuda and K.device == x.device):
        raise ValueError(f"matvec: K ({K.device}) and x ({x.device}) must lie "
                         "on the same CUDA device")
    if K.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matvec: K must be fp32 or bf16, got {K.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"matvec: x must be fp32, got {x.dtype}")
    if K.dim() != 2 or x.shape != (K.shape[1],):
        raise ValueError(f"matvec: K must be (n, m) and x (m,), got "
                         f"{tuple(K.shape)} and {tuple(x.shape)}")
    n, m = K.shape
    if n < 1 or m < 1:
        raise ValueError(f"matvec: empty K {tuple(K.shape)}")
    if K.stride(1) != 1 or (n > 1 and K.stride(0) < m):
        raise ValueError(f"matvec: K must have unit column stride and rows "
                         f"of at least m elements, strides {K.stride()}")
    if not x.is_contiguous():
        raise ValueError("matvec: x must be contiguous")


def matvec(K, x):
    """y = K @ x, fp32 out.

    CPU tensors: ``matvec_plain``. CUDA tensors: the kernel (K fp32 or
    bf16 with unit column stride, x fp32), or an error."""
    if K.device.type == "cpu" and x.device.type == "cpu":
        return matvec_plain(K, x)
    _check(K, x)
    lib = _library()
    n, m = K.shape
    itemsize = K.element_size()
    ld = K.stride(0) if n > 1 else m
    splits, width = split_plan(n, m, itemsize)
    vector = int(K.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
                 and (ld * itemsize) % 16 == 0)
    y = torch.empty(n, dtype=torch.float32, device=K.device)
    work = (torch.empty(splits * n, dtype=torch.float32, device=K.device)
            if splits > 1 else y)
    fn = lib.matvec_f32 if K.dtype == torch.float32 else lib.matvec_bf16
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), x.data_ptr(), y.data_ptr(), work.data_ptr(),
                 n, m, ld, splits, width, vector, stream)
    if err:
        raise RuntimeError(f"matvec kernel launch failed: CUDA error {err}")
    matvec.launches += 1
    return y


matvec.launches = 0
