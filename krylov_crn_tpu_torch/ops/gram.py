"""Gram-space (row-kernel) formulation: data, K build, rep algebra, Lanczos.

Port of ``krylov_crn_tpu/ops/gram.py``. For logistic regression every
iterate, gradient and Krylov vector lies in the affine subspace

    x  =  gamma * x0  +  A^T zeta ,        zeta in R^n

so carrying the representation (gamma, zeta) instead of x closes every
operation over the dense n x n Gram matrix K = A A^T:

    A v      = beta * Ax0 + K w               for v = beta*x0 + A^T w
    H v      = (l2*beta, D(Av)/n + l2 w)      one K-matvec per HVP
    <v, v'>  = closed O(n) form over the carried images u = A v

The feature dimension d appears only in the K build and when an explicit
iterate is materialized. An fp32 K is built as the JAX package builds it,
from three bf16 slices of each column panel on the tensor cores
(``build_K_device``, ``syrk_split_P``), bitwise symmetric panel by panel.
Per Krylov-CRN iteration the solver runs m + 1 K-matvecs, each through
the SYMV kernel on a card (ops/symv.py).

Under a mesh of D ranks (``build_gram(mesh=)``) K is **row-banded**: rank
r keeps rows [r n_pad/D, (r+1) n_pad/D) and everything else (Ax0, b, mask,
every solver vector) is replicated. A K-matvec is then the band's product
with the replicated vector, a rectangular dense matvec through the matvec
kernel on a card (ops/matvec.py), followed by one all-gather of the
n_pad/D-row results. SYMV is off under a mesh, as in the JAX package: a
band holds no whole upper triangle.

``GramData.K_lr`` is an optional bf16 copy of K (of the band under a
mesh), K rounded to nearest even. ``GramKrylov(bf16_head=True)`` runs the
Lanczos matvecs of its first iterations on it, the bf16 path of the
matvec kernel on a card; margins, gradients and the basis images that the
line search reads keep the fp32 K. ``build_gram`` makes it by default for
fp32 and never for fp64, as the JAX package does. It costs n_pad^2 * 2
bytes beside K (0.84 GB at rcv1-like's n_pad 20480, 0.82 GB at
news20-like's 20224). On the TPU it halved a Lanczos matvec's bytes; on
the card it saves none: a whole bf16 K (n_pad^2 * 2 bytes) is what SYMV
reads of the fp32 K's upper triangle.

``build_gram(cache_dir=)`` keeps the host-built K as ``.npy`` files named
by the JAX package's ``_cache_key`` and the dtype, so that an fp64 build
never reads an fp32 file.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from krylov_crn_tpu_torch.config import as_torch_dtype, resolve_device
from krylov_crn_tpu_torch.ops.math import accum_dot
from krylov_crn_tpu_torch.ops.matvec import matvec
from krylov_crn_tpu_torch.ops.symv import KSlot, symv, symv_at
from krylov_crn_tpu_torch.parallel.mesh import all_gather_rows
from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["GramData", "build_gram", "build_K_device", "syrk_split_pieces",
           "syrk_split_P", "syrk_split_P_plain", "Rep", "rep_dot",
           "rep_scale", "rep_sub", "rep_axpy", "k_matvec", "gram_lanczos",
           "GramLanczosResult", "pad_rows"]

ROW_ALIGN = 256  # the JAX package's CPU padding; a multiple of symv.BLOCK
# columns of the split's big b1 b1^T block per tensor-core sum
# (syrk_split_P): each run starts from zero and is added in fp32
SPLIT_CHUNK = 512


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(n: int) -> int:
    """Row padding of the dense K: 256, the JAX package's CPU granularity,
    so states carried across have identical shapes; the SYMV tile (64)
    divides it."""
    return _round_up(n, ROW_ALIGN)


@dataclasses.dataclass(frozen=True)
class GramData:
    """Dense Gram-space problem data (rows padded to n_pad).

    ``K_lr`` (optional) is a bf16 copy of K, or of this rank's band under
    a mesh, for the Lanczos matvecs of the bf16 head
    (``GramKrylov(bf16_head=True)``); ``K_lanczos`` is it where it exists,
    else K. It adds n_pad^2 * 2 bytes. The card's bf16 matvec reads as many
    bytes as the fp32 SYMV reads of K's upper triangle, so on the card the
    head saves no bandwidth."""

    # (n_pad, n_pad) Gram matrix A A^T, bitwise symmetric; under a mesh of
    # D ranks this rank's (n_pad / D, n_pad) row band of it
    K: torch.Tensor
    Ax0: torch.Tensor  # (n_pad,) margins of the base point x0
    b: torch.Tensor  # (n_pad,) labels in {0,1}, 0 on padding
    mask: torch.Tensor  # (n_pad,) 1 on real rows
    x0_sqnorm: torch.Tensor  # 0-d |x0|^2
    n: int
    d: int
    nnz: int
    mesh: object | None = None  # parallel.mesh.Mesh of several ranks
    K_lr: torch.Tensor | None = None  # bf16 copy of K (or of its band)

    @property
    def n_padded(self) -> int:
        return self.Ax0.shape[0]

    @property
    def K_lanczos(self):
        return self.K if self.K_lr is None else self.K_lr


def _cache_key(A, x0) -> str:
    """The JAX package's key of a cached K (the same hex digest): A's row
    pointers, its first 4096 column indices and values, x0 and A's shape.
    It leaves out the dtype; ``build_gram`` puts that in the file name."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(A.indptr).tobytes())
    h.update(np.ascontiguousarray(A.indices[:4096]).tobytes())
    h.update(np.ascontiguousarray(A.data[:4096]).tobytes())
    h.update(np.asarray(x0).tobytes())
    h.update(str(A.shape).encode())
    return h.hexdigest()[:16]


def _heavy_skew(lens, nnz: int) -> bool:
    """The JAX package's test for heavy column skew: with every panel
    given one window of ``cap`` entries (the longest panel, rounded up to
    8192), the windows together would hold more than four times the nnz.
    Its ``lax.scan`` build leaves the panel scan for a masked-GEMM
    fallback there; the port's eager loop slices each panel at its exact
    length and builds skewed input like any other."""
    cap = _round_up(int(max(lens)) if len(lens) else 1, 8192)
    return len(lens) * cap > 4 * max(1, int(nnz))


def _pack_flat_panels(A, n_pad, dtype, col_block=2048):
    """Host-side packing of the panel build (numpy, as in the JAX
    package): compact empty columns, cut into ``col_block``-wide panels,
    and emit the flat (rows, vals) streams of exactly nnz entries, the
    per-active-column END offsets CE (each nnz's within-panel column is
    rebuilt from them on the device), plus per-panel (start, len)."""
    Acsc = A.tocsc()
    counts = np.diff(Acsc.indptr)
    active = np.flatnonzero(counts)
    if len(active) < Acsc.shape[1]:
        Acsc = Acsc[:, active]
    d = int(Acsc.shape[1])
    cb = min(_round_up(max(d, 1), 512), col_block)
    nblk = -(-d // cb)
    starts = Acsc.indptr[np.arange(nblk) * cb].astype(np.int32)
    ends = Acsc.indptr[np.minimum(np.arange(1, nblk + 1) * cb, d)]
    lens = (ends - starts).astype(np.int32)
    ridt = np.uint16 if n_pad <= 65535 else np.int32
    nnz = int(Acsc.nnz)
    Rf = Acsc.indices.astype(ridt)
    CE = np.full(nblk * cb, nnz, np.int32)
    CE[:d] = Acsc.indptr[1:d + 1]
    Vf = Acsc.data.astype(dtype)
    return Rf, CE, Vf, starts, lens, cb, nblk


def syrk_split_pieces(B):
    """The three bf16 slices of an fp32 panel, B = b1 + b2 + b3 to about
    2^-26 elementwise: b1 is B rounded to nearest even (the JAX package's
    ``reduce_precision(B, 8, 7)``), b2 the rounded remainder, b3 what is
    left. Both subtractions are exact (Sterbenz). Eager only: a compiler
    that folds the f32 -> bf16 -> f32 round trip away (XLA's
    excess-precision pass does, ``krylov_crn_tpu/ops/gram.py:166-171``)
    zeroes the residuals and leaves one bf16 pass (elementwise error
    ~3.8e-3), so this never goes under ``torch.compile``."""
    b1 = B.to(torch.bfloat16)
    r1 = B - b1.float()
    b2 = r1.to(torch.bfloat16)
    b3 = (r1 - b2.float()).to(torch.bfloat16)
    return b1, b2, b3


def _split_operands(B, X=None, Y=None):
    """X = [b1/2 | b2/2 | b1 | b1] and Y = [b1 | b2 | b2 | b3], each
    (n x 4cb) bf16, written into ``X`` and ``Y`` when given. Halving is
    exact (an exponent shift)."""
    n, cb = B.shape
    if X is None:
        X = torch.empty((n, 4 * cb), dtype=torch.bfloat16, device=B.device)
        Y = torch.empty_like(X)
    b1, b2, b3 = syrk_split_pieces(B)
    X3, Y3 = X.view(n, 4, cb), Y.view(n, 4, cb)
    torch.mul(b1, 0.5, out=X3[:, 0])
    torch.mul(b2, 0.5, out=X3[:, 1])
    X3[:, 2] = b1
    X3[:, 3] = b1
    Y3[:, 0] = b1
    Y3[:, 1] = b2
    Y3[:, 2] = b2
    Y3[:, 3] = b3
    return X, Y


def syrk_split_P(B, X=None, Y=None, P=None):
    """Asymmetric half-Gram P with P + P^T = B B^T to fp32 accuracy, for
    an fp32 panel B: the counterpart of ``_syrk_split_P``
    (``krylov_crn_tpu/ops/gram.py:141-184``). Expanding B B^T over the
    slices and dropping (2,3), (3,3) (~2^-27, below fp32 resolution):

        P = 0.5 b1 b1^T + 0.5 b2 b2^T + b1 b2^T + b1 b3^T = X @ Y^T

    on the tensor cores, bf16 in, fp32 accumulation and fp32 out
    (``aten::mm.dtype_out``, cuBLAS), four times B B^T's flops at the bf16
    rate. Every product of two slices is exact in fp32, so P is an fp32
    sum of exact terms, as in the JAX package.

    The tensor cores' fp32 accumulation rounds toward zero at the ulp of
    the running sum, so the order of the contraction matters. The three
    small blocks (0.5 b2 b2^T + b1 b2^T + b1 b3^T, depth 3cb) go first,
    into P; the big 0.5 b1 b1^T block follows in runs of ``SPLIT_CHUNK``
    columns, each summed on the tensor cores from zero and added onto P in
    the epilogue (``addmm``, beta 1, fp32 rounded to nearest). In one call
    of depth 4cb, the JAX package's single ``dot_general``, every term of
    the small blocks lands on a sum that already holds the big block and
    drops up to one ulp of it, all the same way: on the first 4,096 rows
    of rcv1-like a K-matvec error of 7.4e-7 against fp64 (fp32 SGEMM
    1.3e-7). Small blocks first and the big block whole: 8.0e-8, but K's
    entries still lean toward zero and GramCRN's fp32 run on rcv1-like
    stalled at a 2e-6 gap; with the big block in runs of 512 columns K is
    at least as accurate as an fp32 SGEMM's on every panel measured, and
    GramCRN crosses where it did on the SGEMM's K (PERF.md, "K build";
    ``krylov_crn_tpu_torch/tools/measure_splitk.py``).

    ``X``, ``Y`` (n x 4cb bf16) and ``P`` (n x n fp32) are reused when
    given. A CPU tensor takes the plain version; a CUDA one takes the
    bf16 products or raises: there is no fp32 SGEMM or bf16-output
    fallback. ``syrk_split_P.cuda_calls`` counts the panels whose bf16
    products were launched on the card."""
    if not B.is_cuda:
        return syrk_split_P_plain(B)
    if not all("dtype_out" in op.overloads()
               for op in (torch.ops.aten.mm, torch.ops.aten.addmm)):
        raise RuntimeError(
            f"syrk_split_P: torch {torch.__version__} lacks aten::mm or "
            "aten::addmm .dtype_out, the bf16 x bf16 -> fp32 products of "
            "the split K build")
    X, Y = _split_operands(B, X, Y)
    n, cb = B.shape
    if P is None:
        P = torch.empty((n, n), dtype=torch.float32, device=B.device)
    torch.mm(X[:, cb:], Y[:, cb:].T, out_dtype=torch.float32, out=P)
    for a in range(0, cb, SPLIT_CHUNK):
        c = slice(a, min(a + SPLIT_CHUNK, cb))
        torch.addmm(P, X[:, c], Y[:, c].T, out_dtype=torch.float32, out=P)
    syrk_split_P.cuda_calls += 1
    return P


syrk_split_P.cuda_calls = 0


def syrk_split_P_plain(B):
    """The plain version of ``syrk_split_P``: the same X and Y upcast to
    fp32 and multiplied in fp32. The terms are the same exact products;
    only the order of the fp32 sums differs."""
    X, Y = _split_operands(B)
    return X.float() @ Y.float().T


def _use_split(dtype) -> bool:
    """fp32 panels take the split, as the JAX package's ``_use_split``
    routes fp32 at HIGHEST, the precision of its every device build; fp64
    panels take the plain product."""
    return dtype == torch.float32


def _panel_accum(K, B, bufs=None):
    """K += B B^T in place, the counterpart of ``_panel_accum``
    (``krylov_crn_tpu/ops/gram.py:199-217``). fp32: K += (P + P^T) with
    the pair summed first: P + P^T is bitwise symmetric (fp addition
    commutes), so K stays bitwise symmetric after every panel (``K + P +
    P^T`` in two steps would not, nor would ``P.add_(P.T)``, which reads
    entries it has overwritten). ``bufs`` = (X, Y, P, S): the split's
    operands, P and the pair sum, reused from panel to panel. fp64:
    ``addmm_``, symmetrized by the caller."""
    if _use_split(B.dtype):
        X, Y, P, S = bufs or (None,) * 4
        P = syrk_split_P(B, X, Y, P)
        K.add_(P + P.T if S is None else torch.add(P, P.T, out=S))
    else:
        K.addmm_(B, B.T)


def build_K_device(A, n_pad: int, dtype, device, col_block: int = 2048):
    """K = A A^T built on ``device`` from ``col_block``-wide column panels.

    Each panel's nnz are scattered into a dense (n_pad x cb) buffer B
    (CSR holds no duplicates, so a plain ``index_put_`` without atomics),
    and K accumulates B B^T through ``_panel_accum``: for fp32 the JAX
    package's split (three bf16 slices, bf16 products with fp32 output on
    the tensor cores, ``syrk_split_P``), which keeps K bitwise
    symmetric panel by panel; for fp64 ``addmm_``, then one
    symmetrization at the end, 0.5 * (K + K^T), bitwise symmetric because
    fp addition commutes and halving is exact (the SYMV kernel reads only
    the upper triangle). Every panel is sliced at its own length, so one
    panel holding most of the nnz (heavy column skew) costs no more than
    its entries. ``build_K_device.panels`` counts the panels built;
    beside ``syrk_split_P.cuda_calls`` it shows that every fp32 panel on
    the card went through the bf16 products. The split's buffers, allocated
    once per build: X and Y (n_pad x 4cb bf16 each), P and the pair sum
    (n_pad^2 fp32 each), 3.9 GB beside K at n_pad 20224."""
    with span("gram.build_K.pack", host=True):
        Rf, CE, Vf, starts, lens, cb, nblk = _pack_flat_panels(
            A, n_pad, np.dtype(dtype), col_block)
    tdt = as_torch_dtype(dtype)
    rows = torch.from_numpy(Rf.astype(np.int64)).to(device)
    vals = torch.from_numpy(Vf).to(device)
    col_ends = torch.from_numpy(CE.astype(np.int64)).to(device)
    K = torch.zeros((n_pad, n_pad), dtype=tdt, device=device)
    B = torch.empty((n_pad, cb), dtype=tdt, device=device)
    split = _use_split(tdt)
    bufs = None
    if split and K.is_cuda:
        X = torch.empty((n_pad, 4 * cb), dtype=torch.bfloat16, device=device)
        bufs = (X, torch.empty_like(X), torch.empty_like(K),
                torch.empty_like(K))
    for i in range(nblk):
        s, ln = int(starts[i]), int(lens[i])
        # within-panel column of entry p = #{column ends <= s + p}; ends of
        # other panels' columns and the padding clamp to ln and drop out
        ce = torch.clamp(col_ends[i * cb:(i + 1) * cb] - s, 0, ln)
        c = torch.cumsum(torch.bincount(ce, minlength=ln + 1)[:ln], 0)
        B.zero_()
        B.index_put_((rows[s:s + ln], c), vals[s:s + ln])
        _panel_accum(K, B, bufs)
        build_K_device.panels += 1
    if split:
        return K
    K = K + K.T
    return K.mul_(0.5)


build_K_device.panels = 0


def _host_K(A, x0, dtype, cache_dir):
    """scipy's A A^T (n x n, ``dtype``) on the host, read from and saved
    to ``cache_dir`` when given. The file holds what the JAX package's
    cache holds, under the JAX package's key, with the dtype added to its
    name: the JAX package's name has none, so there an fp64 build after an
    fp32 one reads the fp32 K."""
    dtype = np.dtype(dtype)
    cache_file = None
    if cache_dir is not None:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        cache_file = (Path(cache_dir)
                      / f"gram_{_cache_key(A, x0)}_{dtype.name}.npy")
        if cache_file.exists():
            return np.load(cache_file)
    K = np.asarray((A @ A.T).todense(), dtype)
    if cache_file is not None:
        np.save(cache_file, K)
    return K


def build_gram(A, b, x0, dtype=np.float32, cache_dir: str | None = None,
               low_res_lanczos: bool | None = None, device=None,
               device_build: bool | None = None, mesh=None) -> GramData:
    """GramData from a scipy CSR matrix on ``device``.

    ``device_build`` (default: True on a card) builds K on the device
    (build_K_device); otherwise K is scipy's ``A @ A.T`` on the host, as
    the JAX package's ``build_gram(device_build=False)`` does, kept in
    ``cache_dir`` when given (``gram_{key}_{dtype}.npy``; a device build
    ignores the cache, as in the JAX package).

    ``low_res_lanczos`` (default: on for fp32, off for fp64) adds
    ``K_lr``, K in bf16.

    ``mesh`` (several ranks; every rank calls this with the same A): the
    data lies on the mesh's device and K (and K_lr) is this rank's row
    band. Each rank still builds the whole K and keeps a copy of its band,
    so a band holds the bits of the single-device K."""
    with span("gram.build_K"):
        A = A.tocsr()
        n, d = map(int, A.shape)
        n_pad = pad_rows(n)
        x0 = np.asarray(x0, np.float64)
        if mesh is not None and not mesh.distributed:
            mesh = None
        if mesh is not None and n_pad % mesh.world:
            raise ValueError(
                f"build_gram: the {mesh.world} ranks of the mesh do not "
                f"divide n_pad = {n_pad} (n = {n} padded to a multiple of "
                f"{ROW_ALIGN})")
        dev = resolve_device(device if mesh is None else mesh.device)
        if device_build is None:
            device_build = dev.type == "cuda"
        if device_build:
            K = build_K_device(A, n_pad, dtype, dev)
        else:
            Kp = np.zeros((n_pad, n_pad), dtype)
            Kp[:n, :n] = _host_K(A, x0, dtype, cache_dir)
            K = torch.from_numpy(Kp).to(dev)
        if mesh is not None:
            band = n_pad // mesh.world
            K = K[mesh.rank * band:(mesh.rank + 1) * band].clone()
        if low_res_lanczos is None:
            low_res_lanczos = np.dtype(dtype) == np.float32
        Ax0 = np.zeros(n_pad, dtype)
        Ax0[:n] = A @ x0
        bp = np.zeros(n_pad, dtype)
        bp[:n] = np.asarray(b, dtype)
        mask = np.zeros(n_pad, dtype)
        mask[:n] = 1
        aux = torch.from_numpy(np.stack([Ax0, bp, mask])).to(dev)
        return GramData(
            K=K, Ax0=aux[0], b=aux[1], mask=aux[2],
            x0_sqnorm=torch.tensor(float(x0 @ x0),
                                   dtype=as_torch_dtype(dtype), device=dev),
            n=n, d=d, nnz=int(A.nnz), mesh=mesh,
            K_lr=K.to(torch.bfloat16) if low_res_lanczos else None)


def k_matvec(K, q, mesh=None):
    """K @ q. One device: the SYMV kernel for tensors on a card, its plain
    version on the CPU (ops/symv.py); for a ``KSlot`` (one device) the
    same kernel reading K at the slot's address (``symv_at``). Under a
    ``mesh`` of several ranks K is this rank's row band: the band's product
    with the replicated q (the dense matvec kernel on a card,
    ops/matvec.py), then one all-gather of the ranks' rows into the
    replicated result.

    ``k_matvec.cuda_calls`` and ``k_matvec.band_cuda_calls`` count the
    whole-K and the band calls on a card, so a run can show that each went
    through its kernel (``symv.launches``, ``matvec.launches``)."""
    if mesh is not None and mesh.distributed:
        if K.is_cuda:
            k_matvec.band_cuda_calls += 1
        return all_gather_rows(mesh, matvec(K, q))
    if K.is_cuda:
        k_matvec.cuda_calls += 1
    return symv_at(K, q) if isinstance(K, KSlot) else symv(K, q)


k_matvec.cuda_calls = 0
k_matvec.band_cuda_calls = 0


class Rep(NamedTuple):
    """v = beta * x0 + A^T w, with the image u = A v carried along."""

    beta: torch.Tensor  # 0-d
    w: torch.Tensor  # (n_pad,)
    u: torch.Tensor  # (n_pad,) == beta * Ax0 + K w (maintained by linearity)


def rep_dot(gd: GramData, a: Rep, bv: Rep, adt):
    """<a, b> in the d-space, closed over carried images (no matvec):
    ba*bb*|x0|^2 + ba Ax0.wb + wa.ub. The two dots fold as one batch of
    two rows, each exactly as a single compensated dot would."""
    ba, bb = a.beta.to(adt), bv.beta.to(adt)
    dots = accum_dot(torch.stack([gd.Ax0.to(adt), a.w.to(adt)]),
                     torch.stack([bv.w.to(adt), bv.u.to(adt)]), adt)
    return ba * bb * gd.x0_sqnorm.to(adt) + ba * dots[0] + dots[1]


def rep_scale(a: Rep, s) -> Rep:
    return Rep(a.beta * s, a.w * s, a.u * s)


def rep_sub(a: Rep, b: Rep) -> Rep:
    return Rep(a.beta - b.beta, a.w - b.w, a.u - b.u)


def rep_axpy(y: Rep, alpha, x: Rep) -> Rep:
    return Rep(y.beta + alpha * x.beta, y.w + alpha * x.w,
               y.u + alpha * x.u)


class GramLanczosResult(NamedTuple):
    alphas: torch.Tensor  # (m,)
    betas: torch.Tensor  # (m-1,)
    Vb: torch.Tensor  # (m,) x0-coefficients of the basis
    Vw: torch.Tensor  # (m, n_pad) zeta-components
    Vu: torch.Tensor  # (m, n_pad) images A v_j
    k: torch.Tensor  # valid basis count


def _where_rep(cond, a: Rep, b: Rep) -> Rep:
    return Rep(torch.where(cond, a.beta, b.beta), torch.where(cond, a.w, b.w),
               torch.where(cond, a.u, b.u))


def gram_lanczos(gd: GramData, hop, g: Rep, m: int,
                 reorth_passes: int = 1, breakdown_tol: float = 1e-6,
                 accum_dtype=torch.float32) -> GramLanczosResult:
    """Lanczos on rep-space vectors with fixed m, breakdown masking and
    ``reorth_passes`` full reorthogonalization passes; all inner products
    in closed Gram form. ``hop(v: Rep) -> Rep`` applies H with exactly one
    K-matvec. The loop never reads a value back to the host."""
    cdt = g.w.dtype
    adt = accum_dtype
    npad = g.w.shape[0]
    dev = g.w.device
    zero = torch.zeros((), dtype=cdt, device=dev)

    g_norm = torch.sqrt(torch.clamp(rep_dot(gd, g, g, adt), min=0.0)).to(cdt)
    # numerically-zero gradient: a zero basis rather than 0/0 NaNs
    v = rep_scale(g, 1.0 / torch.where(g_norm > 0, g_norm, 1.0 + zero))

    Vb = torch.zeros(m, dtype=cdt, device=dev)
    Vw = torch.zeros((m, npad), dtype=cdt, device=dev)
    Vu = torch.zeros((m, npad), dtype=cdt, device=dev)
    Vb[0], Vw[0], Vu[0] = v.beta, v.w, v.u

    x0sq = gd.x0_sqnorm.to(adt)
    Ax0 = gd.Ax0.to(adt)

    def reorth(t: Rep) -> Rep:
        for _ in range(reorth_passes):
            # c_j = <V_j, t> for all j (same cancellation as rep_dot)
            tw, tb = t.w.to(adt), t.beta.to(adt)
            Vb_ = Vb.to(adt)
            c = (Vb_ * tb * x0sq + Vb_ * torch.dot(Ax0, tw)
                 + Vw.to(adt) @ t.u.to(adt)).to(cdt)
            t = Rep(t.beta - torch.dot(c, Vb), t.w - c @ Vw, t.u - c @ Vu)
        return t

    v_prev = Rep(zero, torch.zeros(npad, dtype=cdt, device=dev),
                 torch.zeros(npad, dtype=cdt, device=dev))
    beta_prev = zero
    active = torch.ones((), dtype=torch.bool, device=dev)
    k = torch.ones((), dtype=torch.int64, device=dev)
    alphas, betas = [], []
    for j in range(m - 1):
        Hv = hop(v)
        t = rep_axpy(Hv, -beta_prev, v_prev)
        alpha = rep_dot(gd, v, t, adt).to(cdt)
        alphas.append(torch.where(active, alpha, zero))
        t = rep_axpy(t, -alpha, v)
        if reorth_passes > 0:
            t = reorth(t)
        beta = torch.sqrt(torch.clamp(rep_dot(gd, t, t, adt),
                                      min=0.0)).to(cdt)
        ok = torch.abs(beta) >= breakdown_tol
        proceed = active & ok
        beta_j = torch.where(proceed, beta, zero)
        betas.append(beta_j)
        inv = 1.0 / torch.where(ok, beta, 1.0 + zero)
        v_next = _where_rep(proceed, rep_scale(t, inv), v)
        v_prev = _where_rep(proceed, v, v_prev)
        Vb[j + 1] = torch.where(proceed, v_next.beta, Vb[j + 1])
        Vw[j + 1] = torch.where(proceed, v_next.w, Vw[j + 1])
        Vu[j + 1] = torch.where(proceed, v_next.u, Vu[j + 1])
        k = torch.where(proceed, j + 2, k)
        v, beta_prev, active = v_next, beta_j, proceed

    Hv = hop(v)
    alpha_last = rep_dot(gd, v, Hv, adt).to(cdt)
    alphas = torch.stack(alphas + [zero])
    alphas = alphas.index_put((k.reshape(1) - 1,), alpha_last.reshape(1))
    betas = (torch.stack(betas) if betas
             else torch.zeros(0, dtype=cdt, device=dev))
    return GramLanczosResult(alphas=alphas, betas=betas, Vb=Vb, Vw=Vw,
                             Vu=Vu, k=k)
