"""The port's products (krylov_crn_tpu_torch/ops/spmv.py) against the
JAX package's ops/spmv in fp64: the dense branch (the matvec kernel's
plain version on the CPU) and the sparse CSR branch, to 1e-12."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.data.formats import build_dual as jbuild
from krylov_crn_tpu_torch.data.formats import build_dual
from krylov_crn_tpu_torch.ops import spmv as tspmv

# the JAX package's ops/__init__ re-exports spmv the function under the
# module's name
jspmv = importlib.import_module("krylov_crn_tpu.ops.spmv")
from krylov_crn_tpu_torch.ops.matvec import matvec

CPU = "cpu"  # the library's default device is the card


def _pair(want_dense, seed=0):
    rng = np.random.default_rng(seed)
    keep = np.ones(120)
    keep[5] = 0  # an empty row
    A = sp.diags(keep) @ sp.random(120, 45, density=0.2, random_state=rng,
                                   format="csr")
    A = A.tocsr()
    A.eliminate_zeros()
    x = rng.standard_normal(45)
    z = rng.standard_normal(120)
    return (A, jbuild(A, dtype=np.float64, want_dense=want_dense),
            build_dual(A, dtype=np.float64, want_dense=want_dense, device=CPU), x, z)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= 1e-12 * max(np.max(np.abs(want)),
                                                      1.0)


@pytest.mark.parametrize("want_dense", [True, False])
def test_products_match_jax(want_dense):
    A, jd, td, x, z = _pair(want_dense)
    assert (td.dense is not None) == want_dense
    _close(tspmv.spmv(td, torch.from_numpy(x)),
           jspmv.spmv(jd, jnp.asarray(x)))
    _close(tspmv.rmatvec(td, torch.from_numpy(z)),
           jspmv.rmatvec(jd, jnp.asarray(z)))
    _close(tspmv.spmv(td, torch.from_numpy(x)), A @ x)
    _close(tspmv.rmatvec(td, torch.from_numpy(z)), A.T @ z)


@pytest.mark.parametrize("want_dense, l2", [(True, 0.0), (False, 0.0),
                                            (True, 0.1), (False, 0.1)])
def test_hvp_matches_jax(want_dense, l2):
    A, jd, td, x, z = _pair(want_dense, seed=1)
    w = np.abs(z)
    got = tspmv.hvp_sparse(td, torch.from_numpy(w), torch.from_numpy(x),
                           l2=l2)
    want = jspmv.hvp_sparse(jd, jnp.asarray(w), jnp.asarray(x), l2=l2)
    _close(got, want)


def test_row_sqnorms_matches_jax():
    A, jd, td, _, _ = _pair(False, seed=2)
    got = tspmv.row_sqnorms(td.a).numpy()
    _close(got, jspmv.row_sqnorms(jd.a))
    assert got[5] == 0.0


def test_dense_branch_counts_no_cpu_calls():
    _, _, td, x, _ = _pair(True, seed=3)
    before = (tspmv.dense_matvec.cuda_calls, matvec.launches)
    tspmv.spmv(td, torch.from_numpy(x))
    assert (tspmv.dense_matvec.cuda_calls, matvec.launches) == before


def test_sparse_branch_is_repeatable_fp32():
    """The CSR product sums each row in a fixed order: the same bits on
    every call."""
    td32 = build_dual(sp.random(500, 300, density=0.05, random_state=4,
                                format="csr"), dtype=np.float32,
                      want_dense=False, device=CPU)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        300).astype(np.float32))
    y = tspmv.spmv(td32, v)
    assert all(torch.equal(y, tspmv.spmv(td32, v)) for _ in range(5))
