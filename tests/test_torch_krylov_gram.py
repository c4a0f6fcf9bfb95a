"""The port's Gram-space Krylov CRN (krylov_crn_tpu_torch/solvers/
krylov_gram.py) against the JAX package on the CPU: one step from the
same carried state, whole fp64 runs, and the fp32 production path."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.ops.gram import GramData as JGramData
from krylov_crn_tpu.solvers import krylov_gram as jk
from krylov_crn_tpu_torch import GramKrylov, LogisticRegression, Trace
from krylov_crn_tpu_torch.convert import gram_data_from_numpy, state_from_numpy
from krylov_crn_tpu_torch.ops.gram import GramData
from krylov_crn_tpu_torch.solvers import krylov_gram as tk

CPU = "cpu"  # the library's default device is the card

KW = dict(m=10, beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=20,
          reorth_passes=1)
PAIRS = {"value": "value_lo", "Ax": "Ax_lo", "f_best": "f_best_lo"}


def _jax_solver(A, b, dtype, l2=0.0, m=10):
    return jk.GramKrylov(loss=JLoss(A, b, dtype=dtype, l2=l2), reg_coef=1e-3,
                         subspace_dim=m, tolerance=0, tqdm=False)


def _port_solver(A, b, dtype, l2=0.0, m=10):
    return GramKrylov(loss=LogisticRegression(A, b, dtype=dtype, l2=l2, device=CPU),
                      reg_coef=1e-3, subspace_dim=m, tolerance=0, device=CPU)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("l2, after", [(0.0, 0), (0.0, 3), (1e-2, 2)])
def test_one_step_from_carried_state_matches(small_problem, l2, after):
    """Both packages step from the same fp64 state (carried by convert.py):
    every field within 1e-9, solver_it equal. (Late in a run the step is
    ill-conditioned — a summation-order change alone moves it — so the
    states come from the first iterations.)"""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b, np.float64, l2)
    st = ja.init_state(jnp.asarray(x0), 0)
    kw = dict(KW, l2=l2, reg_ceil=1e6)
    for _ in range(after):
        st = jk.gram_krylov_step(ja.gd, st, accum_dtype=jnp.float64, **kw)
    gd = gram_data_from_numpy(jax.device_get(ja.gd), device=CPU)
    st_t = tk.gram_krylov_step(gd, state_from_numpy(jax.device_get(st), device=CPU),
                               accum_dtype=torch.float64, **kw)
    st_j = jax.device_get(jk.gram_krylov_step(ja.gd, st,
                                              accum_dtype=jnp.float64, **kw))
    assert int(st_t.solver_it) == int(st_j.solver_it)
    for f in tk.GramKrylovState._fields:
        if f in PAIRS.values() or f == "solver_it":
            continue
        got, want = getattr(st_t, f).numpy(), getattr(st_j, f)
        if f in PAIRS:
            got = got + getattr(st_t, PAIRS[f]).numpy()
            want = want + getattr(st_j, PAIRS[f])
        assert _rel_err(got, want) < 1e-9, f


@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_run_fused_fp64_trace_matches_jax(small_problem, l2):
    A, b, x0 = small_problem
    tj = _jax_solver(A, b, np.float64, l2).run_fused(x0, it_max=16, chunk=8)
    tt = _port_solver(A, b, np.float64, l2).run_fused(x0, it_max=16, chunk=8)
    assert list(tt.its) == list(tj.its)
    lj, lt = np.asarray(tj.loss_vals), np.asarray(tt.loss_vals)
    assert lt.shape == lj.shape == (17,)
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    # late iterations sit in the ill-conditioned tail, where rounding
    # order alone can change a Newton count
    assert tt.solver_its[:6] == list(tj.solver_its[:6])


def test_fp32_path_reaches_fp64_optimum(small_problem):
    """The production fp32 path (fp32 compensated accumulation, exact host
    fp64 corrections per chunk) reaches the fp64 optimum within 1e-8 — the
    bound test_fp32_pair_solver_matches_fp64_optimum holds the JAX package
    to."""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b, np.float64)
    st = ja.init_state(jnp.asarray(x0), 0)
    st, _ = jk.gram_krylov_multistep(ja.gd, st, chunk=40,
                                     accum_dtype=jnp.float64, l2=0.0, **KW)
    f64 = float(st.value) + float(st.value_lo)

    alg = _port_solver(A, b, np.float32)
    tr = alg.run_fused(x0, it_max=40, chunk=8, certify=True)
    assert alg.state.zeta.dtype == torch.float32
    fs = tr.metrics["exact_fs"]
    # every committed iterate is certified; the run may end early once
    # repeated single-iteration retries no longer improve the exact value
    assert tr.metrics["exact_its"] == list(range(1, alg.it + 1))
    assert min(fs) - f64 < 1e-8
    bfs = tr.metrics["boundary_fs"]
    assert all(b2 <= b1 for b1, b2 in zip(bfs, bfs[1:]))
    lv = np.asarray(tr.loss_vals)
    assert np.all(np.isfinite(lv)) and lv.shape == (alg.it + 1,)


def test_candidate_df_extreme_margins_fp32():
    """Port of the JAX package's guard: the fp32 difference-form change is
    finite and accurate at extreme margins and increments, and agrees
    with the JAX package's."""
    n = 8
    rng = np.random.default_rng(3)
    margins = np.array([-20.0, -17.5, 30.0, 0.3, -0.2, 5.0, -90.0, 2.0])
    incs = np.array([+20.0, +17.0, -100.0, 0.01, -0.05, -3.0, +4.0, 1.0])
    b = (rng.random(n) < 0.5).astype(np.float64)
    t32 = lambda v: torch.tensor(v, dtype=torch.float32)
    gd = GramData(K=torch.zeros((n, n)), Ax0=t32(margins), b=t32(b),
                  mask=torch.ones(n), x0_sqnorm=t32(1.0), n=n, d=n, nnz=n)
    hi, lo = tk._candidate_df(gd, t32(margins), t32(incs), torch.float32)
    got = float(hi) + float(lo)
    assert np.isfinite(got)

    def f64(m):
        ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
        return float(np.mean((1.0 - b) * m - ls))

    want = f64(margins + incs) - f64(margins)
    assert abs(got - want) < 1e-5 * max(1.0, abs(want))
    gj = JGramData(K=jnp.zeros((n, n), jnp.float32),
                   Ax0=jnp.asarray(margins, jnp.float32),
                   b=jnp.asarray(b, jnp.float32), mask=jnp.ones(n, jnp.float32),
                   x0_sqnorm=jnp.asarray(1.0, jnp.float32), K_lr=None, n=n,
                   d=n, nnz=n)
    hj, lj = jk._candidate_df(gj, jnp.asarray(margins, jnp.float32),
                              jnp.asarray(incs, jnp.float32), jnp.float32)
    assert abs(got - (float(hj) + float(lj))) < 1e-7 * max(1.0, abs(want))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gram_value_pair_matches_jax(small_problem, dtype):
    """The pair-margin value with an l2 term. fp64: equal to rounding.
    fp32: the two libraries round logsig/sigmoid differently by up to an
    ulp per term, so the sums agree to fp32 eps times the value, not to
    the pair's resolution."""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b, dtype)
    st = ja.init_state(jnp.asarray(x0, dtype), 0)
    gdj = dataclasses.replace(ja.gd, K_lr=None)
    rng = np.random.default_rng(0)
    Ax = np.asarray(st.Ax) * (1 + rng.standard_normal(st.Ax.shape) * 0.1)
    Ax = Ax.astype(dtype)
    Ax_lo = (rng.standard_normal(st.Ax.shape) * 1e-8).astype(dtype)
    xsq = np.asarray(3.7, dtype)
    adt_j, adt_t = jnp.dtype(dtype), tk.accum_dtype(dtype)
    hj, lj = jk._gram_value(gdj, jnp.asarray(Ax), jnp.asarray(xsq), 1e-2,
                            adt_j, Ax_lo=jnp.asarray(Ax_lo))
    gd = gram_data_from_numpy(jax.device_get(gdj), device=CPU)
    ht, lt = tk._gram_value(gd, torch.from_numpy(Ax), torch.from_numpy(xsq),
                            1e-2, adt_t, Ax_lo=torch.from_numpy(Ax_lo))
    want = float(hj) + float(lj)
    tol = 1e-13 if dtype == np.float64 else np.finfo(np.float32).eps
    assert abs(float(ht) + float(lt) - want) < tol * abs(want)


def test_step_loop_and_trace_match_jax(small_problem, tmp_path):
    """The base run loop (one step per call), checkpoint re-evaluation,
    materialization and Trace persistence."""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b, np.float64, l2=1e-3, m=6)
    tj = ja.run(x0, it_max=8)
    ja.compute_loss_of_iterates()
    alg = _port_solver(A, b, np.float64, l2=1e-3, m=6)
    tt = alg.run(x0, it_max=8)
    alg.compute_loss_of_iterates()
    assert list(tt.its) == list(tj.its)
    np.testing.assert_allclose(tt.loss_vals, tj.loss_vals, rtol=1e-10)
    np.testing.assert_allclose(alg.current_x(), np.asarray(ja.current_x()),
                               rtol=1e-8, atol=1e-10)
    assert alg.loss.f_opt == pytest.approx(ja.loss.f_opt, rel=1e-10)

    tt.save("g.pkl", path=str(tmp_path))
    with open(tmp_path / "g.pkl", "rb") as fh:
        assert isinstance(pickle.load(fh).xs[-1].zeta, np.ndarray)
    back = Trace.from_pickle(str(tmp_path / "g.pkl"), loss=alg.loss)
    np.testing.assert_allclose(back.iterates()[-1], alg.current_x(),
                               rtol=1e-12)


def test_hessian_lipschitz_matches_jax(small_problem):
    A, b, _ = small_problem
    want = JLoss(A, b, dtype=np.float64).hessian_lipschitz
    got = LogisticRegression(A, b, dtype=np.float64, device=CPU).hessian_lipschitz
    assert got == pytest.approx(want, rel=1e-9)
