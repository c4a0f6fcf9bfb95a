"""The SYMV kernel of the port (csrc/symv.cu, ops/symv.py).

On the CPU the kernel cannot run: these tests hold its plain version
against fp64, emulate its two-pass tile walk in PyTorch (the tile
numbering is the kernel's own closed form), and check that the device K
build gives the bitwise-symmetric K the kernel relies on; ``symv_at``
reads the K that its slot names. The tests marked ``cuda`` run the kernel
itself and skip without a card.
"""

import math

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.ops.gram import build_K_device, k_matvec, pad_rows
from krylov_crn_tpu_torch.ops.symv import (
    BLOCK,
    KSlot,
    symv,
    symv_at,
    symv_plain,
)


def _sym(n, seed):
    rng = np.random.default_rng(seed)
    B = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    K = torch.from_numpy(B) @ torch.from_numpy(B).T
    K = (K + K.T) * 0.5  # bitwise symmetric
    q = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return K, q


def _rel(y, K, q):
    want = K.double() @ q.double()
    return float(torch.linalg.norm(y.double() - want) / torch.linalg.norm(want))


def _row_start(i, nb):
    return i * nb - i * (i - 1) // 2


def _tile_coords(t, nb):
    """Python copy of csrc/symv.cu's tile number -> (i, j) map."""
    b = 2.0 * nb + 1.0
    i = max(int(math.floor((b - math.sqrt(b * b - 8.0 * t)) * 0.5)), 0)
    while i > 0 and _row_start(i, nb) > t:
        i -= 1
    while i + 1 < nb and _row_start(i + 1, nb) <= t:
        i += 1
    return i, i + (t - _row_start(i, nb))


def _emulate_two_pass(K, x, bs):
    """The kernel's scheme in PyTorch: pass 1 writes one row partial per
    upper tile and one column partial per off-diagonal tile into W; pass 2
    sums W[r, :, :] in fixed order."""
    n = K.shape[0]
    nb = n // bs
    W = torch.full((nb, nb, bs), float("nan"), dtype=K.dtype)
    for t in range(nb * (nb + 1) // 2):
        i, j = _tile_coords(t, nb)
        T = K[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
        W[i, j] = T @ x[j * bs:(j + 1) * bs]
        if i != j:
            W[j, i] = T.T @ x[i * bs:(i + 1) * bs]
    assert not torch.isnan(W).any(), "a workspace slot was never written"
    y = W[:, 0].clone()
    for s in range(1, nb):
        y = y + W[:, s]
    return y.reshape(n)


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_symv_plain_matches_fp64(nb):
    K, q = _sym(256 * nb, nb)
    assert _rel(symv_plain(K, q), K, q) < 1e-6


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 13, 160, 320])
def test_tile_walk_covers_upper_triangle_once(nb):
    seen = [_tile_coords(t, nb) for t in range(nb * (nb + 1) // 2)]
    assert len(set(seen)) == len(seen)
    assert set(seen) == {(i, j) for i in range(nb) for j in range(i, nb)}
    # row-major, diagonal first, like the Pallas kernel's _upper_blocks
    assert seen == sorted(seen)


@pytest.mark.parametrize("n", [BLOCK, 13 * BLOCK, 768])
def test_two_pass_emulation_matches_matvec(n):
    K, q = _sym(n, n)
    y = _emulate_two_pass(K, q, BLOCK)
    assert _rel(y, K, q) < 1e-6
    np.testing.assert_allclose(y.numpy(), (K @ q).numpy(), rtol=1e-4,
                               atol=1e-5)


def test_symv_on_cpu_is_plain_and_not_counted():
    K, q = _sym(256, 0)
    before = symv.launches
    assert torch.equal(symv(K, q), symv_plain(K, q))
    assert symv.launches == before
    assert pad_rows(20242) == 20480 and pad_rows(20242) % BLOCK == 0


def test_device_build_K_bitwise_symmetric():
    """The fp32 device build (run here on CPU tensors) symmetrizes K, so
    the kernel may read the upper triangle only; several panels."""
    import scipy.sparse as sp

    rng = np.random.default_rng(5)
    n, d = 300, 6000
    A = sp.random(n, d, density=0.02, random_state=rng, format="csr",
                  dtype=np.float32)
    n_pad = pad_rows(n)
    K = build_K_device(A, n_pad, np.float32, torch.device("cpu"))
    assert torch.equal(K, K.T), "device K build is not bitwise symmetric"
    want = (A.astype(np.float64) @ A.T.astype(np.float64)).toarray()
    err = np.abs(K.numpy()[:n, :n] - want).max()
    assert err <= 1e-6 * np.abs(want).max()
    assert not K[n:].any() and not K[:, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_symv_at_on_cpu_reads_the_K_its_slot_names(dtype):
    """On the CPU ``symv_at`` (and ``k_matvec`` of a slot) is the plain
    product with the K the slot last named, uncounted; the slot takes only
    a K of its shape, dtype and device, refuses to be read before it names
    one, and keeps no K alive: once the K it names is gone, reading it
    raises."""
    (K1, q), (K2, _) = _sym(256, 1), _sym(256, 2)
    K1, K2, q = K1.to(dtype), K2.to(dtype), q.to(dtype)
    slot = KSlot(256, dtype, "cpu")
    with pytest.raises(ValueError):
        symv_at(slot, q)
    before = symv.launches
    for K in (K1, K2, K1):
        slot.point(K)
        assert torch.equal(symv_at(slot, q), symv_plain(K, q))
        assert torch.equal(k_matvec(slot, q), symv_plain(K, q))
    assert symv.launches == before and not slot.is_cuda
    for wrong in (K1[:128, :128], K1.T, K1.float() if dtype ==
                  torch.float64 else K1.double()):
        with pytest.raises(ValueError):
            slot.point(wrong)
    slot.point(K2)
    del K, K2
    with pytest.raises(ValueError):
        symv_at(slot, q)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [BLOCK, 13 * BLOCK, 4096])
def test_symv_kernel_on_card(cuda_device, n):
    K, q = _sym(n, n)
    K, q = K.to(cuda_device), q.to(cuda_device)
    before = symv.launches
    y = symv(K, q)
    torch.cuda.synchronize()
    assert symv.launches == before + 1
    assert _rel(y, K, q) < 1e-6
    assert torch.equal(y, symv(K, q)), "kernel is not deterministic"
    with pytest.raises(TypeError):
        symv(K.double(), q.double())
    with pytest.raises(ValueError):
        symv(K[:-1, :-1].contiguous(), q[:-1].contiguous())


@pytest.mark.cuda
def test_symv_on_skew_built_K_on_card(cuda_device):
    """SYMV on a K built on the card from heavily skewed input (one dense
    panel, then thousands of one-entry columns): the build keeps K
    bitwise symmetric, which is all the kernel asks of it."""
    import scipy.sparse as sp

    from krylov_crn_tpu_torch.ops.gram import _pack_flat_panels, _heavy_skew

    rng = np.random.default_rng(3)
    n, tail = 1000, 20000
    head = sp.random(n, 2048, density=0.1, random_state=rng, format="csc",
                     dtype=np.float32)
    ones = sp.csc_matrix(
        (rng.standard_normal(tail).astype(np.float32),
         rng.integers(0, n, tail), np.arange(tail + 1)), shape=(n, tail))
    A = sp.hstack([head, ones]).tocsr()
    n_pad = pad_rows(n)
    assert _heavy_skew(_pack_flat_panels(A, n_pad, np.float32)[4], A.nnz)
    K = build_K_device(A, n_pad, np.float32, cuda_device)
    assert torch.equal(K, K.T)
    want = (A.astype(np.float64) @ A.T.astype(np.float64)).toarray()
    err = np.abs(K.cpu().numpy()[:n, :n] - want).max()
    assert err <= 1e-5 * np.abs(want).max()  # fp32 panel GEMMs
    q = torch.rand(n_pad, device=cuda_device)
    before = symv.launches
    y = symv(K, q)
    torch.cuda.synchronize()
    assert symv.launches == before + 1
    assert _rel(y, K, q) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20480, 20224])
def test_symv_at_equals_symv_on_card(cuda_device, n):
    """At the Gram cells' n_pad: the slot entry gives the direct entry's
    bits on two Ks, called directly and from one CUDA graph captured on
    the first K and replayed after the slot names the second."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    Ks = []
    for _ in range(2):
        B = torch.randn(n, 256, device=cuda_device, generator=gen) / 16.0
        K = B @ B.T
        Ks.append((K + K.T) * 0.5)  # bitwise symmetric
        del B, K
    q = torch.randn(n, device=cuda_device, generator=gen)
    slot = KSlot(n, torch.float32, cuda_device)
    before = symv.launches
    for K in Ks:
        slot.point(K)
        assert torch.equal(symv_at(slot, q), symv(K, q))
    assert symv.launches == before + 4
    slot.point(Ks[0])
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        symv_at(slot, q)  # warm on the capture stream
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = symv_at(slot, q)
    for K in (Ks[1], Ks[0]):
        slot.point(K)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, symv(K, q))
    with pytest.raises(TypeError):
        symv_at(KSlot(n, torch.float64, cuda_device), q.double())

