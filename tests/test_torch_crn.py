"""The port's full-space CRN (krylov_crn_tpu_torch/solvers/crn.py) and
its subproblem solvers against the JAX package in fp64: CubicNewton
"full" and "CG" trajectories, one step from a carried state, the
gradient-norm early exit, and cg_solve / cubic_subproblem_eigh /
cubic_solve_cg on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.ops.cg import cg_solve as jcg
from krylov_crn_tpu.ops.subproblem import cubic_solve_cg as jcubic_cg
from krylov_crn_tpu.ops.subproblem import cubic_subproblem_eigh as jcubic_eigh
from krylov_crn_tpu.solvers import crn as jc
from krylov_crn_tpu_torch import CubicNewton, LogisticRegression
from krylov_crn_tpu_torch.convert import crn_state_from_numpy
from krylov_crn_tpu_torch.ops.cg import cg_solve
from krylov_crn_tpu_torch.ops.subproblem import (
    cubic_solve_cg,
    cubic_subproblem_eigh,
)
from krylov_crn_tpu_torch.solvers import crn as tc
from krylov_crn_tpu_torch.solvers.krylov_crn import initial_state

STEP_KW = dict(beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=200,
               reg_ceil=1e6)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("solver, l2", [("full", 0.0), ("full", 1e-2),
                                        ("CG", 0.0)])
def test_trajectory_matches_jax(small_problem, solver, l2):
    A, b, x0 = small_problem
    kw = dict(reg_coef=1e-3, cubic_solver=solver, tolerance=0)
    ja = jc.CubicNewton(loss=JLoss(A, b, dtype=np.float64, l2=l2), tqdm=False,
                        **kw)
    tj = ja.run(jnp.asarray(x0), it_max=8)
    ja.compute_loss_of_iterates()
    loss = LogisticRegression(A, b, dtype=np.float64, l2=l2)
    alg = CubicNewton(loss=loss, **kw)
    tt = alg.run(x0, it_max=8)
    alg.compute_loss_of_iterates()
    assert list(tt.its) == list(tj.its)
    np.testing.assert_allclose(tt.loss_vals, tj.loss_vals, rtol=1e-11)
    assert tt.solver_its[:4] == list(tj.solver_its[:4])
    assert loss.f_opt == pytest.approx(ja.loss.f_opt, rel=1e-11)


@pytest.mark.parametrize("solver", ["full", "CG"])
def test_one_step_from_carried_state_matches(small_problem, solver):
    A, b, x0 = small_problem
    jl = JLoss(A, b, dtype=np.float64)
    ja = jc.CubicNewton(loss=jl, reg_coef=1e-3, cubic_solver=solver,
                        tolerance=0, tqdm=False)
    st = ja.init_state(jnp.asarray(x0), 0)
    jstep = jc.crn_step_full if solver == "full" else jc.crn_step_cg
    tstep = tc.crn_step_full if solver == "full" else tc.crn_step_cg
    st = jstep(jl.data, jl.b, st, accum_dtype=jnp.float64, **STEP_KW)
    st_j = jax.device_get(jstep(jl.data, jl.b, st, accum_dtype=jnp.float64,
                                **STEP_KW))
    loss = LogisticRegression(A, b, dtype=np.float64)
    st_t = tstep(loss.data, loss.b_t,
                 crn_state_from_numpy(jax.device_get(st)),
                 accum_dtype=torch.float64, **STEP_KW)
    assert int(st_t.solver_it) == int(st_j.solver_it)
    for f in ("x", "Ax", "value", "reg_coef", "r0", "diff_norm",
              "grad_norm", "f_best"):
        assert _rel_err(getattr(st_t, f).numpy(), getattr(st_j, f)) < 1e-9, f


def test_grad_norm_early_exit(small_problem):
    A, b, x0 = small_problem
    loss = LogisticRegression(A, b, dtype=np.float64)
    st = initial_state(loss, x0, 1e-3, tc.CRNState)
    out = tc.crn_step_full(loss.data, loss.b_t, st, tolerance=1e3,
                           accum_dtype=torch.float64)
    assert torch.equal(out.x, st.x) and float(out.diff_norm) == 0.0
    assert float(out.grad_norm) > 0


def _spd(d, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((d, d))
    return B @ B.T / d + 0.1 * np.eye(d), rng.standard_normal(d)


def test_cg_solve_matches_jax():
    """On a small system, where CG ends at d iterations with the residual
    far below the threshold: the count is decided by the algorithm, not
    by rounding near the threshold (on long runs the two libraries'
    matvec rounding moves the crossing by one iteration)."""
    H, g = _spd(12, 0)
    Ht, Hj = torch.from_numpy(H), jnp.asarray(H)
    x, it = cg_solve(lambda v: Ht @ v, torch.from_numpy(g), rtol=1e-8,
                     accum_dtype=torch.float64)
    xj, itj = jcg(lambda v: Hj @ v, jnp.asarray(g), rtol=1e-8,
                  accum_dtype=jnp.float64)
    assert it == int(itj)
    assert _rel_err(x.numpy(), xj) < 1e-10
    assert _rel_err(x.numpy(), np.linalg.solve(H, g)) < 1e-8


@pytest.mark.parametrize("M", [0.05, 3.0])
def test_cubic_subproblem_solvers_match_jax(M):
    H, g = _spd(30, 1)
    Ht, Hj = torch.from_numpy(H), jnp.asarray(H)
    e = cubic_subproblem_eigh(torch.from_numpy(g), Ht, M, r0=0.1)
    ej = jcubic_eigh(jnp.asarray(g), Hj, M, r0=0.1)
    c = cubic_solve_cg(lambda v: Ht @ v, torch.from_numpy(g), M, 0.1,
                       accum_dtype=torch.float64)
    cj = jcubic_cg(lambda v: Hj @ v, jnp.asarray(g), M, 0.1,
                   accum_dtype=jnp.float64)
    for got, want in ((e, ej), (c, cj)):
        assert int(got.iterations) == int(want.iterations)
        assert _rel_err(got.s.numpy(), want.s) < 1e-9
        assert float(got.r) == pytest.approx(float(want.r), rel=1e-9)
        assert float(got.model_decrease) == pytest.approx(
            float(want.model_decrease), rel=1e-9)
    # both backends solve the same problem: lam = M ||s||
    assert float(e.r) == pytest.approx(M * float(torch.linalg.norm(e.s)),
                                       rel=1e-7)
    assert _rel_err(c.s.numpy(), e.s.numpy()) < 1e-5
