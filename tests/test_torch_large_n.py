"""The stress tool's matrix generator, its device-built DualSparse and
the sparse HVP against the JAX package, on the CPU at a small size."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.ops.spmv import hvp_sparse as jhvp
from krylov_crn_tpu_torch.data.formats import dual_from_coo
from krylov_crn_tpu_torch.ops.spmv import hvp_sparse, rmatvec, spmv
from krylov_crn_tpu_torch.tools import measure_large_n as tool

REPO = Path(__file__).resolve().parent.parent
N, D, NNZ = 2000, 3000, 50_000


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_large_n", REPO / "tools" / "measure_large_n.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def coo():
    return tool.device_powerlaw_coo(N, D, NNZ, seed=0, device="cpu")


def test_generator_is_row_sorted_powerlaw_and_seeded(coo):
    rows, cols, vals = coo
    assert rows.dtype == cols.dtype == torch.int64
    assert vals.dtype == torch.float32
    assert rows.shape == cols.shape == vals.shape == (NNZ,)
    assert bool((rows[1:] >= rows[:-1]).all())
    assert 0 <= int(rows.min()) and int(rows.max()) < N
    assert 0 <= int(cols.min()) and int(cols.max()) < D
    # P(col = k) ~ 1/(k+1): the first column alone draws 1/ln(d+1) of all
    share = float((cols == 0).float().mean())
    assert abs(share - np.log(2) / np.log(D + 1)) < 0.01
    again = tool.device_powerlaw_coo(N, D, NNZ, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(coo, again))
    other = tool.device_powerlaw_coo(N, D, NNZ, seed=1, device="cpu")
    assert not torch.equal(other[1], cols)


def test_device_dual_is_consistent_with_scipy(coo):
    """A and A^T against one scipy COO with duplicates summed (the draw
    repeats (row, column) pairs, the products sum them)."""
    rows, cols, vals = coo
    data = tool.build_device_dual(N, D, NNZ, seed=0, device="cpu")
    M = sp.coo_matrix((vals.double().numpy(), (rows.numpy(), cols.numpy())),
                      shape=(N, D)).tocsr()
    assert M.nnz < NNZ  # the draw does repeat pairs
    assert data.shape == (N, D) and data.nnz == NNZ
    assert data.dense is None and data.dense_t is None
    crow = data.a.crow_indices().numpy()
    np.testing.assert_array_equal(
        crow, np.searchsorted(rows.numpy(), np.arange(N + 1)))
    at_rows = np.repeat(np.arange(D), np.diff(data.at_indptr.numpy()))
    assert (np.diff(at_rows) >= 0).all()
    # the stable sort keeps each transpose row's columns ascending
    at_cols = data.at.col_indices().numpy()
    same_row = at_rows[1:] == at_rows[:-1]
    assert (np.diff(at_cols)[same_row] >= 0).all()
    assert data.max_col_nnz == int(np.bincount(cols.numpy()).max())
    for as_dense, want in ((data.a, M), (data.at, M.T)):
        np.testing.assert_allclose(as_dense.to_dense().double().numpy(),
                                   want.toarray(), rtol=0, atol=1e-5)


def test_hvp_matches_jax_fp64(coo):
    """hvp_sparse on the device-built format against the JAX package's on
    the same arrays, fp64: rel <= 1e-12 (two summation orders)."""
    rows, cols, vals = coo
    jtool = _jax_tool()
    jtool.device_powerlaw_coo = lambda n, d, nnz, seed=0: (
        jnp.asarray(rows.numpy(), jnp.int32),
        jnp.asarray(cols.numpy(), jnp.int32),
        jnp.asarray(vals.double().numpy()))
    jdata = jtool.build_device_dual(N, D, NNZ)
    tdata = dual_from_coo(rows, cols, vals.double(), N, D)
    rng = np.random.default_rng(2)
    w, v = rng.random(N), rng.standard_normal(D)
    for l2 in (0.0, 1e-2):
        want = np.asarray(jhvp(jdata, jnp.asarray(w), jnp.asarray(v), l2=l2))
        got = hvp_sparse(tdata, torch.from_numpy(w), torch.from_numpy(v),
                         l2=l2).numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    # both directions separately, against scipy
    M = sp.coo_matrix((vals.double().numpy(), (rows.numpy(), cols.numpy())),
                      shape=(N, D)).tocsr()
    np.testing.assert_allclose(spmv(tdata, torch.from_numpy(v)).numpy(),
                               M @ v, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rmatvec(tdata, torch.from_numpy(w)).numpy(),
                               M.T @ w, rtol=1e-12, atol=1e-12)


def test_json_row_has_the_jax_tools_keys():
    """Every field of the JAX tool's committed row is in the port's, with
    the same meaning; the port adds the card and the two bounds."""
    with open(REPO / "artifacts" / "stress" / "stress1m.json") as fh:
        jax_row = json.load(fh)
    row = tool.result_row(1_000_000, 1_000_000, 100_000_000, build_s=1.234,
                          hvp_s=0.05, card="some card, 700.00 W")
    assert set(jax_row) <= set(row)
    assert row["config"] == jax_row["config"]
    assert row["hvp_gnnz_per_s"] == row["spmv_gnnz_per_s"] == 4.0
    # what the function needs: A and A^T once at 4 B a value and 4 B a
    # column index, 2M + 2 row pointers, w and v in and the result out
    need = 2 * 100e6 * 8 + 4 * (2e6 + 2) + 4 * 3e6
    assert row["bound_ms"] == pytest.approx(need / 3.35e12 * 1e3, abs=1e-4)
    assert row["share_of_bound"] == pytest.approx(row["bound_ms"] / 50.0,
                                                  abs=1e-4)  # 4 decimals
    # what the format streams: the same with int64 indices and pointers
    fmt = 2 * 100e6 * 12 + 8 * (2e6 + 2) + 4 * 3e6
    assert row["format_index_bytes"] == 8
    assert row["format_bound_ms"] == pytest.approx(fmt / 3.35e12 * 1e3,
                                                   abs=1e-4)
    assert row["share_of_format_bound"] == pytest.approx(
        row["format_bound_ms"] / 50.0, abs=1e-4)
    assert row["device"] == "some card, 700.00 W"


def test_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        tool.run(100, 100, 1000)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tool.device_powerlaw_coo(100, 100, 1000)
