"""The port's DualSparse (krylov_crn_tpu_torch/data/formats.py) against
scipy and the JAX package's build_dual: CSR A and A^T, the dense-copy
decision, at_indptr and max_col_nnz, empty rows and columns, and the
16-byte row alignment of the dense copies."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.data.formats import build_dual as jbuild
from krylov_crn_tpu_torch.data.formats import build_dual, padded_dense


def _empty_rows_cols():
    dense = np.zeros((6, 5))
    dense[0, 1] = 2.0
    dense[4, 4] = -1.0
    dense[4, 1] = 0.5
    return sp.csr_matrix(dense)


CASES = {
    "random": lambda: sp.random(40, 90, density=0.15, random_state=3,
                                format="csr"),
    "tall": lambda: sp.random(300, 7, density=0.3, random_state=4,
                              format="csr"),
    "empty_rows_cols": _empty_rows_cols,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("want_dense", [None, False, True])
def test_dual_matches_scipy_and_jax(case, want_dense):
    A = CASES[case]()
    ours = build_dual(A, dtype=np.float64, want_dense=want_dense)
    theirs = jbuild(A, dtype=np.float64, want_dense=want_dense)
    assert ours.a.layout == torch.sparse_csr
    assert ours.at.layout == torch.sparse_csr
    assert ours.shape == theirs.shape == A.shape
    assert ours.nnz == A.nnz
    np.testing.assert_array_equal(ours.a.to_dense().numpy(), A.toarray())
    np.testing.assert_array_equal(ours.at.to_dense().numpy(), A.toarray().T)
    np.testing.assert_array_equal(ours.at_indptr.numpy(),
                                  np.asarray(theirs.at_indptr))
    assert ours.max_col_nnz == theirs.max_col_nnz
    assert (ours.dense is None) == (theirs.dense is None)
    assert (ours.dense_t is None) == (ours.dense is None)
    if ours.dense is not None:
        np.testing.assert_array_equal(ours.dense.numpy(),
                                      np.asarray(theirs.dense))
        np.testing.assert_array_equal(ours.dense_t.numpy(), A.toarray().T)


def test_want_dense_rule_matches_jax():
    """Both sides keep the dense copy under the same byte and width
    thresholds (n*d*itemsize <= limit and d <= 2048)."""
    A = sp.random(64, 2049, density=0.01, random_state=5, format="csr")
    B = sp.random(64, 2048, density=0.01, random_state=5, format="csr")
    for M in (A, B):
        for dtype, limit in ((np.float32, 64 * 2048 * 4),
                             (np.float64, 64 * 2048 * 4)):
            got = build_dual(M, dtype=dtype, dense_threshold_bytes=limit)
            want = jbuild(M, dtype=dtype, dense_threshold_bytes=limit)
            assert (got.dense is None) == (want.dense is None), (M.shape,
                                                                 dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_dense_rows_are_16_byte_aligned(dtype):
    M = torch.arange(7 * 300, dtype=torch.float64).reshape(7, 300).to(dtype)
    for src in (M, M.T):  # A and A^T: rows of 300 and of 7 elements
        t = padded_dense(src)
        assert t.shape == src.shape and t.dtype == dtype
        assert (t.stride(0) * t.element_size()) % 16 == 0
        assert t.data_ptr() % 16 == 0
        assert torch.equal(t, src)
