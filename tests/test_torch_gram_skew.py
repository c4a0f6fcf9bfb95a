"""The K build under heavy column skew: the JAX package leaves its panel
scan for a masked-GEMM fallback there, the port's one eager loop slices
each panel at its exact length. Both against host A A^T."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.ops import gram as jg
from krylov_crn_tpu_torch.ops import gram as tg

CPU = torch.device("cpu")
N, N_PAD = 300, 512


@pytest.fixture(scope="module")
def skewed():
    """One dense-ish panel (2,048 columns at 10% density) followed by
    20,000 columns of one entry each: 11 panels whose longest holds three
    quarters of the entries."""
    rng = np.random.default_rng(3)
    head = sp.random(N, 2048, density=0.1, random_state=rng, format="csc")
    tail_cols = 20000
    tail = sp.csc_matrix(
        (rng.standard_normal(tail_cols), rng.integers(0, N, tail_cols),
         np.arange(tail_cols + 1)), shape=(N, tail_cols))
    gap = sp.csc_matrix((N, 37))  # empty columns are compacted away
    return sp.hstack([head, gap, tail]).tocsr()


def test_input_is_skewed_for_both_packages(skewed):
    assert jg._pack_flat_panels(skewed, N_PAD, np.float64) is None
    Rf, CE, Vf, starts, lens, cb, nblk = tg._pack_flat_panels(
        skewed, N_PAD, np.float64)
    assert tg._heavy_skew(lens, skewed.nnz)
    # the streams hold the entries and nothing more
    assert len(Rf) == len(Vf) == skewed.nnz == int(lens.sum())
    assert (cb, nblk) == (2048, 11) and len(CE) == nblk * cb


@pytest.mark.parametrize("dtype,rtol,atol", [
    (np.float64, 0.0, 1e-12),  # two fp64 summation orders
    (np.float32, 1e-5, 1e-5),  # fp32-class error of either build
], ids=["fp64", "fp32"])
def test_skewed_build_matches_jax_fallback_and_host(skewed, dtype, rtol, atol):
    K = tg.build_K_device(skewed, N_PAD, dtype, CPU)
    assert torch.equal(K, K.T), "K is not bitwise symmetric"
    Kj = np.asarray(jax.device_get(jg._build_K_device(skewed, N_PAD, dtype)))
    host = np.zeros((N_PAD, N_PAD))
    host[:N, :N] = (skewed @ skewed.T).toarray()
    scale = np.abs(host).max()
    np.testing.assert_allclose(K.numpy(), Kj, rtol=rtol, atol=atol * scale)
    np.testing.assert_allclose(K.numpy(), host, rtol=rtol, atol=atol * scale)


def test_build_gram_takes_skewed_input(skewed):
    b = np.ones(N)
    gd = tg.build_gram(skewed, b, np.ones(skewed.shape[1]) * 0.5,
                       dtype=np.float64, device="cpu", device_build=True)
    assert gd.K.shape == (N_PAD, N_PAD) and gd.nnz == skewed.nnz


def _padded_layout(A, n_pad, dtype, col_block=2048):
    """The packing as the JAX package lays it out (streams padded by one
    window of zeros), for input that is not skewed."""
    Rf, CE, Vf, starts, lens, cb, _, nblk = jg._pack_flat_panels(
        A, n_pad, dtype, col_block)
    return Rf, CE, Vf, starts, lens, cb, nblk


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,n,d,density", [(11, 300, 700, 0.05),
                                              (4, 200, 5000, 0.02)])
def test_unskewed_build_unchanged_bitwise(monkeypatch, dtype, seed, n, d,
                                          density):
    """Dropping the zero tail of the streams changes no bit of K: the
    build from the padded layout and from the exact one agree bitwise
    (the first case is tests/test_torch_gram.py's fixture)."""
    rng = np.random.default_rng(seed)
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < density)
    A = sp.csr_matrix(Ad)
    n_pad = tg.pad_rows(n)
    assert not tg._heavy_skew(tg._pack_flat_panels(A, n_pad, dtype)[4], A.nnz)
    K_exact = tg.build_K_device(A, n_pad, dtype, CPU)
    monkeypatch.setattr(tg, "_pack_flat_panels", _padded_layout)
    K_padded = tg.build_K_device(A, n_pad, dtype, CPU)
    assert torch.equal(K_exact, K_padded)
