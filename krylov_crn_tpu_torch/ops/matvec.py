"""Dense matrix-vector product y = K @ x with fp32 accumulation.

``matvec`` launches the hand-written CUDA kernel ``csrc/matvec.cu`` for
tensors on a card: K (n, m) in fp32 or bf16 with any leading dimension,
x and y fp32, streamed by TMA bulk copies through a shared-memory ring,
on a persistent grid that cuts the work into equal runs of (row tile,
column chunk) units, with a fixed summation order, in one launch (see
the source's header). It replaces the Pallas
TPU kernel ``tools/measure_matvec.py:_matvec_kernel``, and it carries the
d-space dense branch of ``ops/spmv.py`` (``A x`` on the dense copy of A,
``A^T z`` on the dense copy of A^T) and the row-band K-matvec under a mesh
(``ops/gram.py:k_matvec``).

``matvec_plain`` is the same function in plain PyTorch. ``matvec`` takes
it only for tensors that lie on the CPU; a tensor on a card goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

__all__ = ["matvec", "matvec_plain", "split_plan", "make_plan", "Plan"]

THREADS = 256  # csrc/matvec.cu's consumer threads (and a producer warp)
STAGES = 3  # csrc/matvec.cu's ring slots
BLOCKS_PER_SM = 3  # csrc/matvec.cu's resident blocks per SM
LONG_VECS = 128  # 16-byte vectors per row chunk of a long row (one warp)
SHORT_TILE_VECS = 1536  # a short-row tile holds at most this many vectors
# the H100's SMs, on every card: the plan, and so each row's summation
# order, is a function of the shape only
SMS = 132
GRID = SMS * BLOCKS_PER_SM  # persistent blocks, BLOCKS_PER_SM to an SM

_lib = None
# per (device, stream): the kernel's tile tickets, zero between launches
# (the kernel resets each one it uses)
_tickets: dict = {}


def _library():
    global _lib
    if _lib is None:
        from krylov_crn_tpu_torch.ops._kernels import load_library

        lib = load_library("matvec")
        args = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        for fn in (lib.matvec_f32, lib.matvec_bf16):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.matvec_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.matvec_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


class Plan(NamedTuple):
    """How the kernel cuts an (n, m) product: ``lpr`` lanes per row,
    tiles of ``tr`` = 256 / lpr rows by ``tcv`` 16-byte vectors, ``ct``
    column chunks per row, ``units`` = row tiles x ct, ``grid`` blocks
    with equal contiguous runs of units, and whether some row tile is
    shared by several blocks (``combine``: its partials are summed through
    the workspace and the tile tickets)."""

    lpr: int
    tr: int
    tcv: int
    ct: int
    units: int
    grid: int
    combine: bool


def smem_bytes(p: Plan, itemsize: int) -> int:
    """Dynamic shared memory of one block under plan ``p``: the ring of
    STAGES tiles (with x's chunk beside each tile when a row has several
    chunks) and x, staged once, when it has one."""
    xq = p.tcv * (16 // itemsize) // 4
    return 16 * (STAGES * (p.tr * p.tcv + (xq if p.ct > 1 else 0))
                 + (xq if p.ct == 1 else 0))


def blocks_per_sm(K, smem: int) -> int:
    """How many blocks of the kernel for K's dtype (the TMA variant) one
    SM of K's card holds at ``smem`` bytes of shared memory."""
    lib = _library()
    with torch.cuda.device(K.device):
        r = lib.matvec_blocks_per_sm(int(K.dtype == torch.bfloat16), 1,
                                     smem)
    if r < 0:
        raise RuntimeError(f"matvec occupancy query failed: CUDA error {-r}")
    return r


def unit_start(b: int, units: int, grid: int) -> int:
    """The first unit of block b (csrc/matvec.cu: unit_start)."""
    return b * units // grid


def _cdiv(a, b):
    return -(-a // b)


def make_plan(n: int, m: int, itemsize: int, tr: int, tcv: int,
              grid: int = GRID) -> Plan:
    """The plan of tiles of ``tr`` rows by ``tcv`` 16-byte vectors (``tr``
    a power of two from 8 to 256) for an (n, m) matrix, on at most
    ``grid`` blocks."""
    units = _cdiv(n, tr) * _cdiv(_cdiv(m, 16 // itemsize), tcv)
    ct = units // _cdiv(n, tr)
    grid = min(units, grid)
    combine = any(unit_start(b, units, grid) % ct
                  for b in range(1, grid))
    return Plan(THREADS // tr, tr, tcv, ct, units, grid, combine)


def split_plan(n: int, m: int, itemsize: int) -> Plan:
    """The kernel's plan for an (n, m) matrix of ``itemsize``-byte
    elements, a function of the shape only. Long rows (more than 128
    vectors) are read by a warp in chunks of 128 vectors on GRID blocks;
    where there are fewer row tiles than SMs, every tile is shared by many
    blocks, and chunks of 256 vectors on one block per SM cut the partials
    each tile's sum gathers. A short row is one chunk, with as many rows
    to a tile (a power of two, 8 to 256) as keep the tile under
    ``SHORT_TILE_VECS`` vectors, on one block per SM, whose longer run of
    units streams behind one fill of its ring. (w8a's shapes, measured
    with ``tools/compare_matvec --profile``.)"""
    mv = _cdiv(m, 16 // itemsize)
    if mv > LONG_VECS:
        tr = THREADS // 32
        if _cdiv(n, tr) < SMS:
            return make_plan(n, m, itemsize, tr, 2 * LONG_VECS, SMS)
        return make_plan(n, m, itemsize, tr, LONG_VECS)
    tr = THREADS
    while tr > THREADS // 32 and tr * mv > SHORT_TILE_VECS:
        tr //= 2
    return make_plan(n, m, itemsize, tr, mv, SMS)


def _tile_tickets(device, stream: int, tiles: int):
    key = (device, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < tiles:
        t = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _bulk_copies_fit(K, x, ld: int) -> bool:
    """Whether the kernel may copy K by whole 16-byte vectors: K and x
    16-byte aligned, rows a whole number of vectors apart, and the last
    row's storage running to the vector that holds column m - 1."""
    n, m = K.shape
    itemsize = K.element_size()
    per = 16 // itemsize
    end = K.storage_offset() + (n - 1) * ld + -(-m // per) * per
    return (K.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
            and (ld * itemsize) % 16 == 0
            and K.untyped_storage().nbytes() >= end * itemsize)


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


def matvec(K, x, plan: Plan | None = None):
    """y = K @ x, fp32 out.

    CPU tensors: ``matvec_plain``. CUDA tensors: the kernel (K fp32 or
    bf16 with unit column stride, x fp32), or an error. ``plan`` replaces
    ``split_plan``'s, to measure other cuts of the same product."""
    if K.device.type == "cpu" and x.device.type == "cpu":
        return matvec_plain(K, x)
    _check(K, x)
    lib = _library()
    n, m = K.shape
    itemsize = K.element_size()
    ld = K.stride(0) if n > 1 else m
    p = split_plan(n, m, itemsize) if plan is None else plan
    vector = int(_bulk_copies_fit(K, x, ld))
    y = torch.empty(n, dtype=torch.float32, device=K.device)
    fn = lib.matvec_f32 if K.dtype == torch.float32 else lib.matvec_bf16
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        if p.combine:
            work = torch.empty(2 * p.grid * p.tr, dtype=torch.float32,
                               device=K.device)
            tickets = _tile_tickets(K.device, stream, p.units // p.ct)
        else:
            work = tickets = y
        err = fn(K.data_ptr(), x.data_ptr(), y.data_ptr(), work.data_ptr(),
                 tickets.data_ptr(), n, m, ld, p.lpr, p.tcv, p.ct, p.grid,
                 vector, stream)
    if err:
        raise RuntimeError(f"matvec kernel launch failed: CUDA error {err}")
    matvec.launches += 1
    key = (n, m, str(K.dtype).removeprefix("torch."))
    matvec.shape_launches[key] = matvec.shape_launches.get(key, 0) + 1
    return y


# launches of the kernel, in all and by (n, m, dtype) of K
matvec.launches = 0
matvec.shape_launches = {}
