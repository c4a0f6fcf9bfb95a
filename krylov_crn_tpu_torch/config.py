"""Numerics policy and device selection for the PyTorch port.

Mirrors ``krylov_crn_tpu/config.py``: fp32 matrix products must be real
fp32 (the Gram solver chases 1e-8 suboptimality gaps, and a silently
reduced-precision GEMM in the line search or the K build stalls the
gap — PERF.md "The fp32 matmul precision cliff"). On an NVIDIA card the
reduced mode is TF32, which keeps about three decimal digits, so both
cuBLAS and cuDNN TF32 switches are turned off at import, and so are
cuBLAS's reduced-precision reductions in bf16 and fp16 products.

The accumulation policy is explicit instead of a global x64 switch:
fp32 storage accumulates in fp32 compensated (two-float) pairs, the
production configuration; fp64 storage accumulates in fp64.
"""

from __future__ import annotations

import torch

__all__ = ["pin_fp32_matmul_precision", "accum_dtype", "resolve_device"]


def pin_fp32_matmul_precision() -> None:
    """Full-fp32 matmuls everywhere (no TF32 in cuBLAS or cuDNN), and no
    reduced-precision reductions inside a bf16 or fp16 product: the split
    K build (``ops/gram.syrk_split_P``) sums its bf16 products in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def accum_dtype(storage_dtype) -> torch.dtype:
    """Accumulation dtype for a storage dtype: fp32 -> fp32 (reductions
    run as compensated pairs, ops/math.py), fp64 -> fp64."""
    return as_torch_dtype(storage_dtype)


def as_torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy or torch float dtype (fp32 / fp64 only)."""
    if isinstance(dtype, torch.dtype):
        if dtype in (torch.float32, torch.float64):
            return dtype
        raise ValueError(f"unsupported storage dtype {dtype!r}")
    import numpy as np

    if np.dtype(dtype) == np.float32:
        return torch.float32
    if np.dtype(dtype) == np.float64:
        return torch.float64
    raise ValueError(f"unsupported storage dtype {dtype!r}")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first card, ``cuda:0``; the CPU only when asked for
    (``device="cpu"``). A CUDA device without a usable card raises: no
    entry point falls back to the CPU."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        how = "is the default" if device is None else "was requested"
        raise RuntimeError(
            f"device {dev} {how} but torch.cuda.is_available() is False; "
            "pass device=\"cpu\" to run on the CPU")
    return dev
