"""The port's Gram-space CRN (krylov_crn_tpu_torch/solvers/crn_gram.py)
against the JAX package on the CPU: CG over reps, one step from a carried
fp64 state, a 6-iteration fp64 run, the d-space CRN-CG it mirrors, the
gradient-norm early exit, and an fp32 run's exact-value stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.ops.gram import Rep as JRep
from krylov_crn_tpu.ops.gram import rep_axpy as jrep_axpy
from krylov_crn_tpu.solvers import crn_gram as jcg
from krylov_crn_tpu_torch import CubicNewton, GramCRN, LogisticRegression
from krylov_crn_tpu_torch.convert import gram_data_from_numpy, state_from_numpy
from krylov_crn_tpu_torch.ops.gram import Rep, rep_axpy
from krylov_crn_tpu_torch.solvers import crn_gram as tcg

CPU = "cpu"  # the library's default device is the card

STEP_KW = dict(beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=200,
               cg_maxiter=500, reg_ceil=1e6)
PAIRS = {"value": "value_lo", "Ax": "Ax_lo", "f_best": "f_best_lo"}


@pytest.fixture(scope="module")
def gram_problem():
    """test_gram.py's wide problem (n << d, the Gram regime)."""
    rng = np.random.default_rng(11)
    n, d = 300, 700
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    A = sp.csr_matrix(Ad)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.4 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return A, b, np.ones(d) * 0.5


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _jax_solver(A, b, l2=0.0):
    return jcg.GramCRN(loss=JLoss(A, b, dtype=np.float64, l2=l2),
                       reg_coef=1e-3, tolerance=0, tqdm=False)


def _port_solver(A, b, dtype=np.float64, l2=0.0, **kw):
    return GramCRN(loss=LogisticRegression(A, b, dtype=dtype, l2=l2, device=CPU),
                   reg_coef=1e-3, **kw, device=CPU)


@pytest.mark.parametrize("l2, lam", [(0.0, 1e-2), (1e-2, 1e-3)])
def test_cg_rep_matches_jax(gram_problem, l2, lam):
    """CG on (H + lam I) s = -g in rep space: the same iteration count and
    the solution at rtol 1e-11 (fp64)."""
    A, b, x0 = gram_problem
    ja = _jax_solver(A, b, l2)
    st = ja.init_state(jnp.asarray(x0), 0)
    g, _, D, _, _ = jcg._grad_probe(ja.gd, st, l2, jnp.float64)
    hop = jcg._hop(ja.gd, D, l2, jnp.float64)
    rhs = JRep(-g.beta, -g.w, -g.u)
    sj, itj = jcg.cg_rep(ja.gd, lambda v: jrep_axpy(hop(v), lam, v), rhs,
                         1e-8, 500, jnp.float64)
    gd = gram_data_from_numpy(jax.device_get(ja.gd), device=CPU)
    t = lambda a: torch.from_numpy(np.array(a))
    hop_t = tcg._hop(gd, t(D), l2)
    s, it = tcg.cg_rep(gd, lambda v: rep_axpy(hop_t(v), lam, v),
                       Rep(t(rhs.beta), t(rhs.w), t(rhs.u)), 1e-8, 500,
                       torch.float64)
    assert it == int(itj) and 0 < it < 500
    for f in ("beta", "w", "u"):
        assert _rel_err(getattr(s, f).numpy(), getattr(sj, f)) < 1e-11, f


@pytest.mark.parametrize("l2, after", [(0.0, 0), (0.0, 2), (1e-2, 1)])
def test_one_step_from_carried_state_matches(gram_problem, l2, after):
    """Both packages step from the same fp64 state: every field at rtol
    1e-11, solver_it equal."""
    A, b, x0 = gram_problem
    ja = _jax_solver(A, b, l2)
    st = ja.init_state(jnp.asarray(x0), 0)
    kw = dict(STEP_KW, l2=l2)
    for _ in range(after):
        st = jcg.gram_crn_step(ja.gd, st, accum_dtype=jnp.float64, **kw)
    gd = gram_data_from_numpy(jax.device_get(ja.gd), device=CPU)
    st_t = tcg.gram_crn_step(gd, state_from_numpy(jax.device_get(st), device=CPU),
                             accum_dtype=torch.float64, **kw)
    st_j = jax.device_get(jcg.gram_crn_step(ja.gd, st,
                                            accum_dtype=jnp.float64, **kw))
    assert int(st_t.solver_it) == int(st_j.solver_it)
    for f in tcg.GramKrylovState._fields:
        if f in PAIRS.values() or f == "solver_it":
            continue
        got, want = getattr(st_t, f).numpy(), getattr(st_j, f)
        if f in PAIRS:
            got = got + getattr(st_t, PAIRS[f]).numpy()
            want = want + getattr(st_j, PAIRS[f])
        assert _rel_err(got, want) < 1e-11, f


def test_trajectory_matches_jax(gram_problem):
    """6 iterations of the run loop in fp64: loss values at rtol 1e-10,
    equal Newton counts, the same empirical f*."""
    A, b, x0 = gram_problem
    ja = _jax_solver(A, b)
    tj = ja.run(x0, it_max=6)
    ja.compute_loss_of_iterates()
    alg = _port_solver(A, b, tolerance=0)
    tt = alg.run(x0, it_max=6)
    alg.compute_loss_of_iterates()
    assert list(tt.its) == list(tj.its)
    np.testing.assert_allclose(tt.loss_vals, tj.loss_vals, rtol=1e-10)
    assert tt.solver_its == list(tj.solver_its)
    assert alg.loss.f_opt == pytest.approx(ja.loss.f_opt, rel=1e-10)
    assert len(tt.metrics["cg_its"]) == 6 and min(tt.metrics["cg_its"]) > 0
    # CG reads its stopping flag once per block of CG_BLOCK iterations
    assert all(c / tcg.CG_BLOCK <= r < c
               for r, c in zip(tt.metrics["host_reads"],
                               tt.metrics["cg_its"]))


def test_gram_crn_matches_standard_cg(gram_problem):
    """GramCRN tracks the port's d-space CRN-CG (the JAX package's
    test_gram_crn_matches_standard_cg, same bounds)."""
    A, b, x0 = gram_problem
    std = CubicNewton(loss=LogisticRegression(A, b, dtype=np.float64,
                                              want_dense=False, device=CPU),
                      reg_coef=1e-3, cubic_solver="CG", tolerance=1e-8)
    std.run(x0=x0, it_max=6)
    gram = _port_solver(A, b, tolerance=1e-8)
    gram.run(x0=x0, it_max=6)
    assert abs(float(gram.state.value) - float(std.state.value)) < 1e-8
    assert abs(float(gram.state.grad_norm) - float(std.state.grad_norm)) \
        < 1e-6 * max(1.0, float(std.state.grad_norm))


def test_early_exit_freezes_state(gram_problem):
    """A tolerance above any gradient norm takes the early branch (the
    JAX package's test_gram_crn_early_exit_freezes_state)."""
    A, b, x0 = gram_problem
    alg = _port_solver(A, b)
    st = alg.init_state(x0, 42)
    st2 = tcg.gram_crn_step(alg.gd, st, tolerance=1e9,
                            accum_dtype=torch.float64)
    assert torch.equal(st2.zeta, st.zeta)
    assert float(st2.diff_norm) == 0.0
    assert float(st2.value) == float(st.value)
    assert np.isfinite(float(st2.grad_norm))


def test_fp32_exact_values_never_rise(gram_problem):
    """fp32 storage on the CPU: every iteration is pinned to its exact fp64
    value, and trust-but-verify keeps those values from rising."""
    A, b, x0 = gram_problem
    alg = _port_solver(A, b, dtype=np.float32, tolerance=0)
    tr = alg.run(x0, it_max=5)
    assert alg.state.zeta.dtype == torch.float32
    fs = tr.metrics["exact_fs"]
    assert tr.metrics["exact_its"] == list(range(1, 6))
    assert np.all(np.isfinite(fs)) and fs[-1] < fs[0]
    assert all(f2 <= f1 for f1, f2 in zip(fs, fs[1:]))


def test_fp32_rollback_restores_the_verified_state(gram_problem):
    """fp32 with l2 = 1e-2: GramCRN reaches its fp32 floor within a few
    iterations, an accepted step then raises the exact value, and
    trust-but-verify rolls it back: the state is the verified snapshot's
    gamma and zeta and the raised reg, bit for bit, and the exact values
    never rise. The JAX package's fp32 GramCRN on the same problem rolls
    back at the same iterations, restores the same reg, and its exact
    values and restored states agree with the port's to fp32 rounding."""
    A, b, x0 = gram_problem
    alg = _port_solver(A, b, dtype=np.float32, l2=1e-2, tolerance=0)
    checks = tcg.watch_rollbacks(alg)
    tr = alg.run(x0, it_max=9)
    rb = tr.metrics.get("rollback_its", [])
    assert rb and len(checks) == len(rb)
    assert all(c["restored"] for c in checks)
    fs = tr.metrics["exact_fs"]
    assert all(f2 <= f1 for f1, f2 in zip(fs, fs[1:]))
    assert all(f > fs[-1] for f in tr.metrics["rollback_fs"])

    ja = jcg.GramCRN(loss=JLoss(A, b, dtype=np.float32, l2=1e-2),
                     reg_coef=1e-3, tolerance=0, tqdm=False)
    jchecks = tcg.watch_rollbacks(ja)
    tj = ja.run(x0, it_max=9)
    assert tj.metrics["rollback_its"] == rb
    assert all(c["restored"] for c in jchecks)
    np.testing.assert_allclose(fs, tj.metrics["exact_fs"], rtol=1e-6)
    for c, cj in zip(checks, jchecks):
        st, sj = c["state"], cj["state"]
        assert st["reg"] == sj["reg"]
        assert abs(st["gamma"] - sj["gamma"]) < 1e-12
        assert _rel_err(st["zeta"], sj["zeta"]) < 1e-6
