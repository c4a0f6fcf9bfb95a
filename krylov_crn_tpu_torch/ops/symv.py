"""Symmetric dense matvec (SYMV) for the Gram solver's hot op.

Every Gram-space iteration runs m + 1 K-matvecs with K = A A^T bitwise
symmetric (ops/gram.py). ``symv`` launches the hand-written CUDA kernel
``csrc/symv.cu`` for tensors on a card; it reads only the upper-triangle
tiles of K, half the bytes of a full matvec, in a deterministic two-pass
scheme (see the source's header). It replaces the Pallas TPU kernel
``krylov_crn_tpu/ops/symv.py:_symv_kernel``.

``symv_plain`` is the same function in plain PyTorch (``K @ x``). ``symv``
takes it only for tensors that lie on the CPU; a tensor on a card goes
through the kernel or the call raises.

``symv_at`` is the same kernel for a K named by a ``KSlot``: a one-element
int64 tensor on the card that holds K's address. A CUDA graph captured
around ``symv(K, x)`` keeps K's address; one captured around
``symv_at(slot, x)`` reads the slot when it is replayed, so it serves any K
of its shape that ``KSlot.point`` names (the Gram step graphs that a
process keeps, ``solvers/krylov_gram``).
"""

from __future__ import annotations

import ctypes
import weakref

import torch

__all__ = ["symv", "symv_at", "symv_plain", "KSlot", "BLOCK"]

BLOCK = 64  # tile edge of csrc/symv.cu (checked against the library)

_lib = None


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("symv")
        lib.symv_upper_block.argtypes = []
        lib.symv_upper_block.restype = ctypes.c_int
        lib.symv_upper_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.symv_upper_f32.restype = ctypes.c_int
        lib.symv_upper_f32_at.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.symv_upper_f32_at.restype = ctypes.c_int
        if lib.symv_upper_block() != BLOCK:
            raise RuntimeError("csrc/symv.cu tile size disagrees with BLOCK")
        _lib = lib
    return _lib


def symv_plain(K, x):
    """y = K @ x in plain PyTorch (reads all of K)."""
    return K @ x


def _check(K, x):
    if not (K.is_cuda and x.is_cuda and K.device == x.device):
        raise ValueError(f"symv: K ({K.device}) and x ({x.device}) must lie "
                         "on the same CUDA device")
    if K.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"symv: fp32 only, got K {K.dtype}, x {x.dtype}")
    n = K.shape[0]
    if K.dim() != 2 or K.shape[1] != n or x.shape != (n,):
        raise ValueError(f"symv: K must be square (n, n) and x (n,), got "
                         f"{tuple(K.shape)} and {tuple(x.shape)}")
    if n % BLOCK:
        raise ValueError(f"symv: n = {n} is not a multiple of {BLOCK}")
    if not (K.is_contiguous() and x.is_contiguous()):
        raise ValueError("symv: K and x must be contiguous")
    if K.data_ptr() % 16:
        raise ValueError("symv: K must be 16-byte aligned (float4 loads)")


def symv(K, x):
    """y = K @ x for a bitwise-symmetric K.

    CPU tensors: ``symv_plain``. CUDA tensors: the upper-triangle kernel
    (fp32, contiguous, n a multiple of ``BLOCK``), or an error."""
    if K.device.type == "cpu" and x.device.type == "cpu":
        return symv_plain(K, x)
    _check(K, x)
    lib = _library()
    n = K.shape[0]
    nb = n // BLOCK
    y = torch.empty_like(x)
    work = torch.empty(nb * nb * BLOCK, dtype=torch.float32, device=K.device)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = lib.symv_upper_f32(K.data_ptr(), x.data_ptr(), y.data_ptr(),
                                 work.data_ptr(), n, stream)
    if err:
        raise RuntimeError(f"symv kernel launch failed: CUDA error {err}")
    symv.launches += 1
    return y


symv.launches = 0


class KSlot:
    """An (n, n) K named by its address: ``slot``, a one-element int64
    tensor on ``device``, holds the address of the K that ``point`` last
    named, and ``symv_at`` reads K there. The slot keeps only a weak
    reference to K: whoever points it keeps K alive while work that reads
    it is queued. ``shape``, ``dtype``, ``device`` and ``is_cuda`` are
    those of the Ks it names."""

    def __init__(self, n: int, dtype, device):
        self.shape = (n, n)
        self.dtype = dtype
        self.device = torch.device(device)
        self.slot = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._named = None

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def point(self, K) -> None:
        """Name ``K`` (contiguous, of the slot's shape, dtype and device):
        its address is written into the slot by a fill on the current
        stream, a kernel argument and no host-to-device copy."""
        if (tuple(K.shape) != self.shape or K.dtype != self.dtype
                or K.device != self.device or not K.is_contiguous()):
            raise ValueError(
                f"KSlot: K {tuple(K.shape)} {K.dtype} on {K.device} "
                f"(contiguous {K.is_contiguous()}) for a slot of "
                f"{self.shape} {self.dtype} on {self.device}")
        if K.data_ptr() % 16:
            raise ValueError("KSlot: K must be 16-byte aligned (float4 "
                             "loads)")
        self.slot.fill_(K.data_ptr())
        self._named = weakref.ref(K)

    def tensor(self):
        """The K that ``point`` last named, while it lives (on the CPU,
        where ``symv_at`` is the plain product with it)."""
        K = self._named() if self._named is not None else None
        if K is None:
            raise ValueError("KSlot: no live K was pointed at")
        return K


def symv_at(K: KSlot, x):
    """``symv`` for the K that ``K.slot`` names: on a card the same tile
    kernel, reading K's address from the slot, with the same bits and
    counted in ``symv.launches``; on the CPU ``symv_plain`` on that K."""
    if not K.is_cuda and x.device.type == "cpu":
        return symv_plain(K.tensor(), x)
    if not (K.is_cuda and x.is_cuda and K.device == x.device):
        raise ValueError(f"symv_at: K ({K.device}) and x ({x.device}) must "
                         "lie on the same CUDA device")
    if K.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"symv_at: fp32 only, got K {K.dtype}, x {x.dtype}")
    n = K.shape[0]
    if x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"symv_at: x must be contiguous ({n},), got "
                         f"{tuple(x.shape)}")
    if n % BLOCK:
        raise ValueError(f"symv_at: n = {n} is not a multiple of {BLOCK}")
    lib = _library()
    nb = n // BLOCK
    y = torch.empty_like(x)
    work = torch.empty(nb * nb * BLOCK, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.symv_upper_f32_at(K.slot.data_ptr(), x.data_ptr(),
                                    y.data_ptr(), work.data_ptr(), n, stream)
    if err:
        raise RuntimeError(f"symv_at kernel launch failed: CUDA error {err}")
    symv.launches += 1
    return y
