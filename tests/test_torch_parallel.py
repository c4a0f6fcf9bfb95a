"""The port's multi-device layer (krylov_crn_tpu_torch/parallel) in four
gloo ranks on the CPU, against the JAX package on its 8-device CPU mesh.

One case for each test of tests/test_parallel.py, with that test's
tolerance: the same seeded inputs go through the JAX function (sharded
over 8 virtual devices, as its own tests run it) and through the port
(sharded over 4 processes). The HLO-regex tests become counter tests on
the mesh's own counts. The four ranks are started once for the module
(``ranks``); every rank returns its results, and the tests read them.

jax is imported inside the tests only: the spawned ranks re-import this
module and must not import JAX.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch import (
    SSCN,
    CubicKrylov,
    GramKrylov,
    LogisticRegression,
)
from krylov_crn_tpu_torch.ops.spmv import hvp_sparse
from krylov_crn_tpu_torch.parallel.launch import run_ranks
from krylov_crn_tpu_torch.parallel.mesh import (
    all_gather_host,
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    broadcast_scalar,
    make_mesh,
    single,
)
from krylov_crn_tpu_torch.parallel.sharded import (
    build_sharded_dual,
    gather_rowvec,
    pad_rowvec,
    partition_rows,
    shard_layout,
    sharded_gather_columns,
    sharded_rmatvec,
    sharded_spmv,
)
from krylov_crn_tpu_torch.solvers.krylov_crn import (
    KrylovState,
    initial_state,
    krylov_step,
)
from krylov_crn_tpu_torch.solvers.krylov_gram import gram_krylov_step
from krylov_crn_tpu_torch.solvers.sscn import sscn_step

CPU = "cpu"  # the library's default device is the card
WORLD = 4
JOIN_S = 120.0
M_GRAM = 10
SSCN_M, SSCN_ITS = 12, 10
COLS = np.array([5, 139, 0, 77, 23, 64, 8, 101], np.int64)


def _labels(seed, n):
    return np.where(np.random.default_rng(seed).standard_normal(n) > 0,
                    1.0, -1.0)


def _problem(n, d, density, state, label_seed):
    A = sp.random(n, d, density=density, random_state=state, format="csr")
    return A, _labels(label_seed, n), np.ones(d) * 0.5


def _np(t):
    return t.detach().cpu().numpy()


def _rank_all(mesh, sscn_I):
    """Everything the module's tests read, computed on one rank."""
    out = {"rank": mesh.rank}
    f64 = np.float64

    # SpMV and transpose SpMV
    A = sp.random(977, 450, density=0.02, random_state=5, format="csr")
    sd = build_sharded_dual(A, mesh, dtype=f64)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(450))
    out["spmv"] = _np(gather_rowvec(sd, sharded_spmv(sd, x)))
    A = sp.random(977, 450, density=0.02, random_state=6, format="csr")
    sd = build_sharded_dual(A, mesh, dtype=f64)
    z = np.random.default_rng(1).standard_normal(977)
    out["rmatvec"] = _np(sharded_rmatvec(sd, pad_rowvec(z, sd)))

    # the oracle, and the collectives of one HVP
    A, b, _ = _problem(500, 300, 0.05, 7, 2)
    rng = np.random.default_rng(2)
    rng.standard_normal(500)
    x, v = rng.standard_normal(300), rng.standard_normal(300)
    sd = build_sharded_dual(A, mesh, dtype=f64)
    loss = LogisticRegression(sd, b, l2=0.01)
    out["value"] = loss.value(x)
    out["gradient"] = _np(loss.gradient(x))
    out["hvp"] = _np(loss.hess_vec_prod(x, v))
    out["max_smoothness"] = loss.max_smoothness
    out["smoothness"] = loss.smoothness
    w = pad_rowvec(np.abs(z[:500]), sd)
    mesh.reset_counts()
    hvp_sparse(sd, w, torch.from_numpy(v))
    out["hvp_counts"] = mesh.counts_snapshot()

    # a whole sharded Krylov-CRN run, and the collectives of one step
    A, b, x0 = _problem(640, 200, 0.05, 8, 3)
    sd = build_sharded_dual(A, mesh, dtype=f64)
    loss = LogisticRegression(sd, b, l2=1e-3)
    alg = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=8,
                      label="sharded")
    alg.run(x0=x0, it_max=12)
    out["krylov_x"] = _np(alg.state.x)
    out["krylov_value"] = float(alg.state.value)
    st = initial_state(loss, x0, 1e-3, KrylovState)
    mesh.reset_counts()
    krylov_step(sd, loss.b_t, st, m=8, l2=1e-3, accum_dtype=torch.float64)
    out["krylov_step_counts"] = mesh.counts_snapshot()

    # sharded SSCN on the same problem, fed the JAX run's coordinates
    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=SSCN_M)
    st = alg.init_state(x0, 42)
    for I in sscn_I:
        st = sscn_step(sd, loss.b_t, st, torch.from_numpy(I), l2=1e-3,
                       accum_dtype=torch.float64, ls_max=200,
                       reg_ceil=1e6)
    out["sscn_x"] = _np(st.x)
    out["sscn_value"] = float(st.value)
    # and with its own generator: every rank must draw the same I
    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=SSCN_M)
    alg.run(x0=x0, it_max=SSCN_ITS)
    out["sscn_own_x"] = _np(alg.state.x)

    # the row-sharded column panel
    A = sp.random(96, 140, density=0.08, random_state=3, format="csr")
    sd = build_sharded_dual(A, mesh, dtype=f64)
    B = all_gather_rows(mesh, sharded_gather_columns(
        sd, torch.from_numpy(COLS)))
    B = B.reshape(WORLD, sd.n_local, len(COLS))
    out["panel"] = np.concatenate(
        [_np(B[i, :c]) for i, c in enumerate(sd.row_counts)])

    # the Gram solver on a row-banded K: fp64 step for step, fp32 fused
    A, b, x0 = _problem(520, 700, 0.05, 9, 4)
    g = GramKrylov(loss=LogisticRegression(A, b, dtype=f64, device=CPU),
                   reg_coef=1e-3, subspace_dim=8, label="sharded",
                   mesh=mesh)
    g.run(x0=x0, it_max=10)
    out["gram_value"] = float(g.state.value)
    out["gram_zeta"] = _np(g.state.zeta)
    out["gram_band_shape"] = tuple(g.gd.K.shape)
    g = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                           device=CPU),
                   reg_coef=1e-3, subspace_dim=8, tolerance=0, label="fused",
                   mesh=mesh)
    tr = g.run_fused(x0, it_max=12, chunk=4, certify=True)
    out["fused_exact_its"] = list(tr.metrics["exact_its"])
    out["fused_exact_fs"] = [float(f) for f in tr.metrics["exact_fs"]]
    out["fused_f0"] = float(tr.loss_vals[0])
    out["fused_zeta"] = _np(g.state.zeta)

    # the collectives of one Gram step at n_pad = 2048
    A, b, x0 = _problem(1948, 4096, 0.004, 10, 5)
    g = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                           device=CPU),
                   reg_coef=1e-3, subspace_dim=M_GRAM, tolerance=0,
                   mesh=mesh)
    st = g.init_state(x0, 42)
    mesh.reset_counts()
    gram_krylov_step(g.gd, st, m=M_GRAM, accum_dtype=torch.float32)
    out["gram_step_counts"] = mesh.counts_snapshot()
    out["gram_step_n_pad"] = g.gd.n_padded

    # the collectives themselves
    r = float(mesh.rank)
    t = torch.tensor([r, 2 * r, -r])
    out["all_reduce_sum"] = _np(all_reduce_sum(mesh, t))
    out["all_reduce_max"] = _np(all_reduce_max(mesh, t))
    out["all_gather_rows"] = _np(all_gather_rows(mesh, t[:2]))
    out["all_gather_host"] = all_gather_host(mesh, np.array([[r, 1.0]]))
    out["broadcast"] = broadcast_scalar(mesh, 10.0 + r)
    return out


def _jax_sscn_run(A, b, x0, mesh):
    """The JAX package's sharded SSCN run, stepped by hand so that each
    step's coordinates can be read off its key; returns (indices, state)."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild
    from krylov_crn_tpu.solvers import sscn as js

    sd = jbuild(A, mesh, dtype=np.float64, pad_to=64)
    jl = JLoss(sd, b, l2=1e-3)
    ja = js.SSCN(loss=jl, reg_coef=1e-3, subspace_dim=SSCN_M, tqdm=False)
    st = ja.init_state(jnp.asarray(x0), 42)
    idx = []
    for _ in range(SSCN_ITS):
        _, sub = jax.random.split(st.key)
        idx.append(np.array(jax.random.choice(
            sub, A.shape[1], shape=(SSCN_M,), replace=False), np.int64))
        st = js.sscn_step(jl.data, jl.b, st, m=SSCN_M, l2=1e-3, beta=0.5,
                          solver_it_max=100, ls_max=200, reg_ceil=1e6,
                          accum_dtype=jnp.float64)
    return idx, jax.device_get(st)


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from krylov_crn_tpu.parallel.mesh import make_mesh as jmake

    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jmake(8)


@pytest.fixture(scope="module")
def jax_sscn(jmesh):
    A, b, x0 = _problem(640, 200, 0.05, 8, 3)
    return _jax_sscn_run(A, b, x0, jmesh)


@pytest.fixture(scope="module")
def ranks(jax_sscn):
    """Every rank's ``_rank_all`` results, from one four-rank launch."""
    res = run_ranks(_rank_all, WORLD, "gloo", CPU, JOIN_S, jax_sscn[0])
    assert [r["rank"] for r in res] == list(range(WORLD))
    return res


def _unpad_j(y_sharded, sd):
    y = np.asarray(y_sharded).reshape(sd.n_shards, sd.n_local)
    mask = np.asarray(sd.mask).reshape(sd.n_shards, sd.n_local).astype(bool)
    return np.concatenate([y[i][mask[i]] for i in range(sd.n_shards)])


def _replicated(ranks, key):
    """Rank 0's value after checking that every rank holds the same
    bits."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(np.asarray(r[key]),
                                      np.asarray(ranks[0][key]), err_msg=key)
    return ranks[0][key]


# ------------------------------- no ranks -------------------------------

def test_partition_rows_nnz_balanced():
    from krylov_crn_tpu.data.synthetic import powerlaw_sparse
    from krylov_crn_tpu.parallel.sharded import partition_rows as jpart

    A = powerlaw_sparse(1000, 500, 20000, seed=1, dtype=np.float64)
    for D in (4, 8):
        ranges = partition_rows(A.indptr, D)
        assert ranges == jpart(A.indptr, D)
        assert ranges[0][0] == 0 and ranges[-1][1] == 1000
        for (s0, e0), (s1, e1) in zip(ranges, ranges[1:]):
            assert e0 == s1
        nnzs = [A.indptr[e] - A.indptr[s] for s, e in ranges]
        assert max(nnzs) <= 1.5 * (sum(nnzs) / len(nnzs)) \
            + A.indptr[-1] * 0.02


def test_shard_layout_matches_jax_arrays(jmesh):
    """All 8 blocks laid out in one process against the JAX package's
    padded COO shards: block height, masks and every block's entries."""
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild

    A = sp.random(977, 450, density=0.02, random_state=5, format="csr")
    sd = jbuild(A, jmesh, dtype=np.float64, pad_to=64)
    lay = shard_layout(A, 8)
    assert lay["n_local"] == sd.n_local
    np.testing.assert_array_equal(np.concatenate(lay["masks"]),
                                  np.asarray(sd.mask))
    nnz_l = sd.a_vals.shape[0] // 8
    rows, cols, vals = (np.asarray(a).reshape(8, nnz_l)
                        for a in (sd.a_rows, sd.a_cols, sd.a_vals))
    for i, blk in enumerate(lay["blocks"]):
        assert blk.shape == (sd.n_local, 450)
        k = blk.nnz
        want = sp.csr_matrix((vals[i, :k], (rows[i, :k], cols[i, :k])),
                             shape=blk.shape)
        assert (blk != want).nnz == 0
        assert not vals[i, k:].any()
    assert sum(b.nnz for b in lay["blocks"]) == A.nnz


def test_single_rank_mesh_is_identity():
    """A mesh of one rank needs no process group; every collective is the
    identity and counts nothing."""
    mesh = make_mesh(device=CPU)
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    t = torch.arange(3.0)
    assert all_reduce_sum(mesh, t) is t and all_reduce_max(mesh, t) is t
    assert all_gather_rows(mesh, t) is t
    assert all_gather_host(mesh, np.arange(3)).shape == (1, 3)
    assert broadcast_scalar(mesh, 2.5) == 2.5
    assert all(c["calls"] == 0 for c in mesh.counts.values())
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(4, CPU)
    A = sp.random(50, 30, density=0.1, random_state=0, format="csr")
    sd = build_sharded_dual(A, single(CPU), dtype=np.float64)
    x = np.random.default_rng(0).standard_normal(30)
    np.testing.assert_allclose(
        _np(sharded_spmv(sd, torch.from_numpy(x)))[:50], A @ x, rtol=1e-12)


def _boom(mesh):
    if mesh.rank == 2:
        raise ValueError("rank two fails")
    return all_reduce_sum(mesh, torch.ones(1))  # the others wait here


def _hang(mesh):
    import time

    time.sleep(60)


def test_run_ranks_reports_a_failed_rank_and_a_timeout():
    with pytest.raises(RuntimeError, match="rank two fails") as ei:
        run_ranks(_boom, 3, "gloo", CPU, 60.0)
    assert "--- rank 2 ---" in str(ei.value)
    with pytest.raises(RuntimeError, match="passed its 3 s limit"):
        run_ranks(_hang, 2, "gloo", CPU, 3.0)


DRIFT_LIMIT_S = 60.0  # well inside run_ranks's join limit


def _drifting_rank(mesh):
    """The fused fp32 Gram race on a row-banded K, where rank 1 flips the
    lowest bit of one zeta entry after the second chunk: every rank must
    stop at that chunk boundary with the same error, not hang."""
    import time

    from krylov_crn_tpu_torch.solvers import krylov_gram as kg

    A, b, x0 = _problem(520, 700, 0.05, 9, 4)
    g = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                           device=CPU),
                   reg_coef=1e-3, subspace_dim=8, tolerance=0, mesh=mesh)
    multistep = kg.gram_krylov_multistep
    chunks = []

    def drifting(gd, state, **kw):
        state, outs = multistep(gd, state, **kw)
        chunks.append(kw["chunk"])
        if mesh.rank == 1 and len(chunks) == 2:
            zeta = state.zeta.clone()
            zeta.view(torch.int32)[3] ^= 1
            state = state._replace(zeta=zeta)
        return state, outs

    kg.gram_krylov_multistep = drifting
    t0 = time.perf_counter()
    try:
        g.run_fused(x0, it_max=12, chunk=4, certify=True)
        error = None
    except RuntimeError as e:
        error = str(e)
    finally:
        kg.gram_krylov_multistep = multistep
    return dict(error=error, seconds=time.perf_counter() - t0,
                counts=mesh.counts_snapshot())


def test_ranks_that_drift_apart_raise_on_every_rank():
    """One flipped bit of replicated state on one rank: both ranks raise
    the same RuntimeError at the next chunk boundary, naming zeta and rank
    1, within DRIFT_LIMIT_S; the hash exchange is counted apart from the
    race's all-gathers."""
    import time

    t0 = time.monotonic()
    res = run_ranks(_drifting_rank, 2, "gloo", CPU, JOIN_S)
    assert time.monotonic() - t0 < DRIFT_LIMIT_S
    assert res[0]["error"] is not None
    assert res[0]["error"] == res[1]["error"]
    assert "zeta on ranks [1] differs from rank 0" in res[0]["error"]
    assert "gamma" not in res[0]["error"]
    for r in res:
        assert r["seconds"] < DRIFT_LIMIT_S
        assert r["counts"]["digest"]["calls"] == 2
        assert r["counts"]["digest"]["max_numel"] == 2 * 8  # 8 fields


def test_build_gram_refuses_indivisible_mesh():
    from krylov_crn_tpu_torch.ops.gram import build_gram
    from krylov_crn_tpu_torch.parallel.mesh import Mesh

    A = sp.random(40, 30, density=0.2, random_state=0, format="csr")
    # a stand-in for a group of three: the refusal comes before any
    # collective
    mesh = Mesh(group=object(), rank=0, world=3, device=torch.device(CPU),
                backend="gloo")
    with pytest.raises(ValueError, match="3 ranks.*n_pad = 256"):
        build_gram(A, np.zeros(40), np.ones(30), dtype=np.float64,
                   device=CPU, mesh=mesh)


# ------------------------------ four ranks ------------------------------

def test_collectives_hand_every_rank_the_same_bytes(ranks):
    np.testing.assert_array_equal(_replicated(ranks, "all_reduce_sum"),
                                  [6.0, 12.0, -6.0])
    np.testing.assert_array_equal(_replicated(ranks, "all_reduce_max"),
                                  [3.0, 6.0, 0.0])
    np.testing.assert_array_equal(_replicated(ranks, "all_gather_rows"),
                                  [0, 0, 1, 2, 2, 4, 3, 6])
    got = _replicated(ranks, "all_gather_host")
    assert got.shape == (4, 1, 2)
    np.testing.assert_array_equal(got[:, 0, 0], [0, 1, 2, 3])
    assert _replicated(ranks, "broadcast") == 10.0


def test_sharded_spmv_matches(ranks, jmesh):
    import jax.numpy as jnp

    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild
    from krylov_crn_tpu.parallel.sharded import sharded_spmv as jspmv

    A = sp.random(977, 450, density=0.02, random_state=5, format="csr")
    x = np.random.default_rng(0).standard_normal(450)
    sd = jbuild(A, jmesh, dtype=np.float64, pad_to=64)
    want = _unpad_j(jspmv(sd, jnp.asarray(x)), sd)
    got = _replicated(ranks, "spmv")
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, A @ x, rtol=1e-12)


def test_sharded_rmatvec_matches(ranks, jmesh):
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild
    from krylov_crn_tpu.parallel.sharded import pad_rowvec as jpad
    from krylov_crn_tpu.parallel.sharded import sharded_rmatvec as jrmatvec

    A = sp.random(977, 450, density=0.02, random_state=6, format="csr")
    z = np.random.default_rng(1).standard_normal(977)
    sd = jbuild(A, jmesh, dtype=np.float64, pad_to=64)
    want = np.asarray(jrmatvec(sd, jpad(z, sd, dtype=np.float64)))
    got = _replicated(ranks, "rmatvec")
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got, A.T @ z, rtol=1e-11, atol=1e-12)


def test_sharded_oracle_matches_single(ranks, jmesh):
    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild

    A, b, _ = _problem(500, 300, 0.05, 7, 2)
    rng = np.random.default_rng(2)
    rng.standard_normal(500)
    x, v = rng.standard_normal(300), rng.standard_normal(300)
    multi = JLoss(jbuild(A, jmesh, dtype=np.float64, pad_to=64), b, l2=0.01)
    single_t = LogisticRegression(A, b, l2=0.01, dtype=np.float64,
                                  device=CPU)
    assert abs(_replicated(ranks, "value") - multi.value(x)) < 1e-12
    assert abs(_replicated(ranks, "value") - single_t.value(x)) < 1e-12
    np.testing.assert_allclose(_replicated(ranks, "gradient"),
                               np.asarray(multi.gradient(x)),
                               rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(_replicated(ranks, "hvp"),
                               np.asarray(multi.hess_vec_prod(x, v)),
                               rtol=1e-11, atol=1e-14)
    # the row-norm maximum and the power iteration cross the ranks too
    np.testing.assert_allclose(_replicated(ranks, "max_smoothness"),
                               multi.max_smoothness, rtol=1e-12)
    np.testing.assert_allclose(_replicated(ranks, "smoothness"),
                               single_t.smoothness, rtol=1e-9)


def test_sharded_krylov_run_matches_single(ranks, jmesh):
    """A whole sharded Krylov-CRN run: the JAX package's on 8 devices and
    the port's single-device run."""
    from krylov_crn_tpu import CubicKrylov as JKrylov
    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild

    A, b, x0 = _problem(640, 200, 0.05, 8, 3)
    loss_8 = JLoss(jbuild(A, jmesh, dtype=np.float64, pad_to=64), b, l2=1e-3)
    alg_8 = JKrylov(loss=loss_8, reg_coef=1e-3, subspace_dim=8, tqdm=False,
                    label="sharded")
    alg_8.run(x0=x0, it_max=12)
    alg_1 = CubicKrylov(
        loss=LogisticRegression(A, b, l2=1e-3, dtype=np.float64, device=CPU,
                                want_dense=False),
        reg_coef=1e-3, subspace_dim=8, label="single")
    alg_1.run(x0=x0, it_max=12)
    x = _replicated(ranks, "krylov_x")
    value = _replicated(ranks, "krylov_value")
    for want_x, want_v in ((np.asarray(alg_8.state.x),
                            float(alg_8.state.value)),
                           (_np(alg_1.state.x), float(alg_1.state.value))):
        np.testing.assert_allclose(x, want_x, rtol=1e-8, atol=1e-10)
        assert abs(value - want_v) < 1e-12


def test_gram_sharded_K_matches_single(ranks, jmesh):
    """Row-banded K, fp64, 10 steps: the JAX package's row-sharded run."""
    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov as JGram

    A, b, x0 = _problem(520, 700, 0.05, 9, 4)
    g8 = JGram(loss=JLoss(A, b), reg_coef=1e-3, subspace_dim=8, tqdm=False,
               label="sharded", mesh=jmesh)
    g8.run(x0=x0, it_max=10)
    assert _replicated(ranks, "gram_band_shape") == (768 // WORLD, 768)
    assert abs(_replicated(ranks, "gram_value")
               - float(g8.state.value)) < 1e-10
    np.testing.assert_allclose(_replicated(ranks, "gram_zeta"),
                               np.asarray(g8.state.zeta),
                               rtol=1e-8, atol=1e-11)


def test_gram_run_fused_sharded_matches_single(ranks, jmesh):
    """The whole fused race (chunks, exact fp64 reinjection, certification,
    trust-but-verify) on a row-banded K in fp32: the JAX package's
    row-sharded run and the port's single-device run."""
    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov as JGram

    A, b, x0 = _problem(520, 700, 0.05, 9, 4)
    j8 = JGram(loss=JLoss(A, b, dtype=np.float32), reg_coef=1e-3,
               subspace_dim=8, tolerance=0, tqdm=False, label="fused",
               mesh=jmesh)
    t8 = j8.run_fused(x0, it_max=12, chunk=4, certify=True,
                      exact_correction=True)
    p1 = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                            device=CPU),
                    reg_coef=1e-3, subspace_dim=8, tolerance=0,
                    label="fused", device=CPU)
    t1 = p1.run_fused(x0, it_max=12, chunk=4, certify=True)
    its = _replicated(ranks, "fused_exact_its")
    fs = np.asarray(_replicated(ranks, "fused_exact_fs"))
    assert its == list(t8.metrics["exact_its"]) \
        == list(t1.metrics["exact_its"])
    np.testing.assert_allclose(fs, np.asarray(t8.metrics["exact_fs"]),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(fs, np.asarray(t1.metrics["exact_fs"]),
                               rtol=1e-5, atol=1e-9)
    bf = [_replicated(ranks, "fused_f0")] + list(fs)
    assert all(b2 <= b1 + 1e-12 for b1, b2 in zip(bf, bf[1:]))
    # the state stayed replicated through every reinjection: the same bits
    # on all four ranks (the JAX test checks that its state kept its mesh
    # placement)
    _replicated(ranks, "fused_zeta")


def test_sharded_gather_columns_matches_dense(ranks, jmesh):
    import jax.numpy as jnp

    from krylov_crn_tpu.parallel.sharded import build_sharded_dual as jbuild
    from krylov_crn_tpu.parallel.sharded import (
        sharded_gather_columns as jgather,
    )

    A = sp.random(96, 140, density=0.08, random_state=3, format="csr")
    sd = jbuild(A, jmesh, dtype=np.float64, pad_to=64)
    Bj = np.asarray(jgather(sd, jnp.asarray(COLS.astype(np.int32))))
    want = np.stack([_unpad_j(Bj[:, j], sd) for j in range(len(COLS))],
                    axis=1)
    got = _replicated(ranks, "panel")
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    np.testing.assert_allclose(got, A[:, COLS].toarray(), rtol=1e-14, atol=0)


def test_sscn_sharded_matches_single(ranks, jax_sscn):
    """Sharded SSCN fed the coordinates of the JAX package's sharded run
    tracks it; with its own seeded generator every rank draws the same
    coordinates, and the run equals the port's single-device one."""
    _, st_j = jax_sscn
    assert abs(_replicated(ranks, "sscn_value") - float(st_j.value)) < 1e-12
    np.testing.assert_allclose(_replicated(ranks, "sscn_x"),
                               np.asarray(st_j.x), rtol=1e-9, atol=1e-12)
    A, b, x0 = _problem(640, 200, 0.05, 8, 3)
    a1 = SSCN(loss=LogisticRegression(A, b, l2=1e-3, dtype=np.float64,
                                      device=CPU, want_dense=False),
              reg_coef=1e-3, subspace_dim=SSCN_M)
    a1.run(x0=x0, it_max=SSCN_ITS)
    np.testing.assert_allclose(_replicated(ranks, "sscn_own_x"),
                               _np(a1.state.x), rtol=1e-9, atol=1e-12)


def test_one_all_reduce_per_hvp(ranks):
    """Design invariant: a sharded fused HVP makes exactly ONE collective,
    the all-reduce of the d-vector after the local transpose product."""
    c = _replicated(ranks, "hvp_counts")
    assert c["all_reduce"] == dict(calls=1, bytes=8 * 300, max_numel=300)
    assert c["all_gather"]["calls"] == 0 and c["broadcast"]["calls"] == 0
    # a d-space Krylov step (m = 8): the gradient and m HVPs, and one
    # two-float all-gather per line-search trial
    c = _replicated(ranks, "krylov_step_counts")
    assert c["all_reduce"]["calls"] == 8 + 1
    assert c["all_reduce"]["max_numel"] == 200
    assert 1 <= c["all_gather"]["calls"] <= 21
    assert c["all_gather"]["max_numel"] == 2 * WORLD


def test_gram_step_collective_budget(ranks):
    """Collective budget of the row-banded Gram step at n_pad = 2048: one
    all-gather of the n_pad-vector per K-matvec, m + 1 of them (the JAX
    step's budget is m + 2; the port leaves out its margin re-derivation
    matvec), and no all-reduce at all, so none of >= 1024 elements: every
    reduction runs on replicated operands."""
    c = _replicated(ranks, "gram_step_counts")
    n_pad = _replicated(ranks, "gram_step_n_pad")
    assert n_pad == 2048
    assert c["all_gather"]["calls"] == M_GRAM + 1 <= M_GRAM + 2
    assert c["all_gather"]["max_numel"] == n_pad
    assert c["all_gather"]["bytes"] == (M_GRAM + 1) * 4 * n_pad
    assert c["all_reduce"]["calls"] == 0
    assert c["all_reduce"]["max_numel"] < 1024
