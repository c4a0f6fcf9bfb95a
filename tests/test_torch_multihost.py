"""The port's per-rank data loading (krylov_crn_tpu_torch/parallel/
multihost.py) in four gloo ranks on the CPU, against the JAX package's
loader on its 8-device CPU mesh and against scipy.

One case for each test of tests/test_multihost.py, with its tolerance
(SpMV and transpose SpMV rtol 1e-9, the oracle's value 1e-12). The four
ranks are started once for the module; jax is imported inside the tests
only, because the spawned ranks re-import this module.
"""

import os

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
from krylov_crn_tpu_torch.models.logistic import LogisticRegression
from krylov_crn_tpu_torch.parallel.launch import run_ranks
from krylov_crn_tpu_torch.parallel.mesh import single
from krylov_crn_tpu_torch.parallel.multihost import (
    global_label_coding,
    init_distributed,
    load_libsvm_rows,
    load_sharded_libsvm,
    split_bytes_by_rows,
)
from krylov_crn_tpu_torch.parallel.sharded import (
    gather_rowvec,
    sharded_rmatvec,
    sharded_spmv,
)
from krylov_crn_tpu_torch.solvers.krylov_crn import CubicKrylov

CPU = "cpu"  # the library's default device is the card
WORLD = 4
JOIN_S = 120.0


def _write_libsvm(path, A, b):
    with open(path, "w") as fh:
        for i in range(A.shape[0]):
            row = A.getrow(i).tocoo()
            toks = " ".join(f"{j + 1}:{v:.17g}"  # 1-based, exact fp64
                            for j, v in zip(row.col, row.data))
            fh.write(f"{int(b[i])} {toks}\n")


@pytest.fixture(scope="module")
def libsvm_file(tmp_path_factory):
    """A small LIBSVM text file and its scipy ground truth."""
    A, b = synthetic_logreg((240, 180, 2400), seed=11)
    path = tmp_path_factory.mktemp("libsvm") / "tiny.libsvm"
    _write_libsvm(path, A, b)
    return str(path), A, b


def _np(t):
    return t.detach().cpu().numpy()


def _rank_all(mesh, path):
    sd, b_pad = load_sharded_libsvm(path, mesh, dtype=np.float64)
    out = dict(rank=mesh.rank, shape=sd.shape, nnz=sd.nnz,
               n_local=sd.n_local, row_counts=sd.row_counts,
               mask_sum=float(sd.mask.sum()), b_pad=_np(b_pad))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(sd.d)
    out["spmv"] = _np(gather_rowvec(sd, sharded_spmv(sd, torch.from_numpy(x))))
    z = rng.standard_normal(sd.n_padded).reshape(WORLD, sd.n_local)
    z_l = torch.from_numpy(z[mesh.rank]) * sd.mask
    out["rmatvec"] = _np(sharded_rmatvec(sd, z_l))
    loss = LogisticRegression(sd, b_pad)
    x0 = np.ones(sd.d) * 0.5
    out["value0"] = loss.value(x0)
    alg = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=6, label="mh")
    alg.run(x0=x0, it_max=5)
    out["value5"] = float(alg.state.value) + float(alg.state.value_lo)
    return out


@pytest.fixture(scope="module")
def ranks(libsvm_file):
    return run_ranks(_rank_all, WORLD, "gloo", CPU, JOIN_S, libsvm_file[0])


def test_init_distributed_single_process_noop(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() == 0
    assert not torch.distributed.is_initialized()


def test_byte_splits_cover_file_and_snap_lines(libsvm_file):
    from krylov_crn_tpu.parallel.multihost import split_bytes_by_rows as jsplit

    path, A, b = libsvm_file
    size = os.path.getsize(path)
    parts = [split_bytes_by_rows(path, 4, k) for k in range(4)]
    assert parts == [jsplit(path, 4, k) for k in range(4)]
    assert parts[0][0] == 0 and parts[-1][1] == size
    for (s0, e0), (s1, e1) in zip(parts, parts[1:]):
        assert e0 == s1  # contiguous
    # parsing the parts reproduces the whole file, with either parser
    for backend in ("native", "python"):
        total_rows = total_nnz = 0
        for rng in parts:
            labels, rows, cols, vals = load_libsvm_rows(path, rng,
                                                        backend=backend)
            total_rows += labels.shape[0]
            total_nnz += vals.shape[0]
        assert total_rows == A.shape[0]
        assert total_nnz == A.nnz


def test_load_sharded_libsvm_matches_scipy(libsvm_file, ranks):
    """Four ranks, each parsing its byte range: the blocks are the file's
    rows in order, so the gathered products equal scipy's on the whole
    matrix and the JAX loader's sorted margins; the oracle's value from
    the prepadded labels equals the host value."""
    import jax.numpy as jnp

    from krylov_crn_tpu.parallel.mesh import make_mesh as jmake
    from krylov_crn_tpu.parallel.multihost import (
        load_sharded_libsvm as jload,
    )
    from krylov_crn_tpu.parallel.sharded import sharded_spmv as jspmv

    path, A, b = libsvm_file
    r0 = ranks[0]
    for r in ranks:
        assert r["shape"] == A.shape and r["nnz"] == A.nnz
        assert r["row_counts"] == r0["row_counts"]
        assert r["n_local"] == r0["n_local"] and r["n_local"] % 8 == 0
        assert r["mask_sum"] == r0["row_counts"][r["rank"]]
    assert sum(r0["row_counts"]) == A.shape[0]

    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[1])
    for r in ranks:
        np.testing.assert_array_equal(r["spmv"], r0["spmv"])
        np.testing.assert_array_equal(r["rmatvec"], r0["rmatvec"])
    np.testing.assert_allclose(r0["spmv"], A @ x, rtol=1e-9)
    sd_j, _ = jload(path, jmake(8), dtype=np.float64, pad_to=64)
    yj = np.asarray(jspmv(sd_j, jnp.asarray(x)))
    np.testing.assert_allclose(np.sort(r0["spmv"]),
                               np.sort(yj[np.asarray(sd_j.mask) > 0]),
                               rtol=1e-9)

    z = rng.standard_normal(WORLD * r0["n_local"]).reshape(WORLD, -1)
    z_orig = np.concatenate([z[i, :c]
                             for i, c in enumerate(r0["row_counts"])])
    np.testing.assert_allclose(r0["rmatvec"], A.T @ z_orig, rtol=1e-9)

    b01 = (np.asarray(b) > 0).astype(np.float64)
    got_b = np.concatenate([r["b_pad"][:c] for r, c in
                            zip(ranks, r0["row_counts"])])
    np.testing.assert_array_equal(got_b, b01)
    m = A @ (np.ones(A.shape[1]) * 0.5)
    want_val = np.mean((1.0 - b01) * m + np.logaddexp(0.0, -m))
    for r in ranks:
        assert abs(r["value0"] - want_val) < 1e-12


def test_sharded_krylov_from_libsvm_runs(ranks):
    """Five sharded Krylov-CRN iterations on the per-rank-loaded data
    lower the value by more than 1e-3, identically on every rank."""
    for r in ranks:
        assert r["value5"] == ranks[0]["value5"]
        assert r["value5"] < r["value0"] - 1e-3


def test_single_rank_loader_is_the_same_code_path(libsvm_file):
    """A mesh of one rank loads the whole file through the same function;
    its products equal scipy's."""
    path, A, b = libsvm_file
    sd, b_pad = load_sharded_libsvm(path, single(CPU), dtype=np.float64)
    assert sd.shape == A.shape and sd.nnz == A.nnz
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    y = _np(sharded_spmv(sd, torch.from_numpy(x)))
    np.testing.assert_allclose(y[:A.shape[0]], A @ x, rtol=1e-9)
    assert not y[A.shape[0]:].any()


def test_global_label_coding_agrees_across_hosts():
    """Labels {3,7} split so that ranks see different first labels must
    not invert classes; the JAX package's function gives the same
    codes."""
    from krylov_crn_tpu.parallel.multihost import (
        global_label_coding as jcoding,
    )

    host0 = np.array([3.0, 7.0, 3.0, 3.0])
    host1 = np.array([7.0, 3.0, 7.0])  # starts with the other class
    rows = []
    for lab in (host0, host1):
        lu = np.unique(lab)
        pad = np.full(3, np.nan)
        pad[: min(len(lu), 3)] = lu[:3]
        rows.append(np.array([*pad, float(lab[0])]))
    gathered = np.stack(rows)

    b0 = global_label_coding(host0, allgather=lambda x: gathered)
    b1 = global_label_coding(host1, allgather=lambda x: gathered)
    np.testing.assert_array_equal(
        b0, jcoding(host0, allgather=lambda x: gathered))
    np.testing.assert_array_equal(
        b1, jcoding(host1, allgather=lambda x: gathered))
    assert set(np.unique(np.concatenate([b0, b1]))) == {0.0, 1.0}
    assert b0[0] == b0[2] == b0[3] == b1[1]  # all the 3s agree
    assert b1[0] == b1[2] == b0[1]  # all the 7s agree
    assert b0[0] != b1[0]

    # standard pairs keep the reference maps (one rank: the default)
    np.testing.assert_array_equal(
        global_label_coding(np.array([-1.0, 1.0])), [0.0, 1.0])
    np.testing.assert_array_equal(
        global_label_coding(np.array([1.0, 2.0])), [0.0, 1.0])
    np.testing.assert_array_equal(
        global_label_coding(np.array([0.0, 1.0])), [0.0, 1.0])
    with pytest.raises(ValueError, match="no more than 2"):
        global_label_coding(np.array([0.0, 1.0, 2.0]))
