"""The port's d-space Krylov CRN (krylov_crn_tpu_torch/solvers/
krylov_crn.py) against the JAX package on the CPU: one step from the same
carried state, a 30-iteration fp64 trajectory, the fp32 path against the
fp64 optimum, and the dense and sparse branches giving the same step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.solvers import krylov_crn as jk
from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
from krylov_crn_tpu_torch.convert import krylov_state_from_numpy
from krylov_crn_tpu_torch.solvers import krylov_crn as tk

KW = dict(m=10, beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=20,
          reorth_passes=1, reg_ceil=1e6)
PAIRS = {"value": "value_lo", "f_best": "f_best_lo"}


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _f64(A, b, x):
    """Exact fp64 loss of x on the host."""
    m = A @ np.asarray(x, np.float64)
    b01 = (np.asarray(b) > 0).astype(np.float64)
    ls = np.where(m < 0, m - np.log1p(np.exp(m)), -np.log1p(np.exp(-m)))
    return float(np.mean((1.0 - b01) * m - ls))


def _jax_run(A, b, x0, l2, steps, want_dense=None):
    loss = JLoss(A, b, dtype=np.float64, l2=l2, want_dense=want_dense)
    alg = jk.CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10,
                         tolerance=0, tqdm=False)
    st = alg.init_state(jnp.asarray(x0), 0)
    states = [st]
    for _ in range(steps):
        st = jk.krylov_step(loss.data, loss.b, st, l2=l2,
                            accum_dtype=jnp.float64, **KW)
        states.append(st)
    return loss, states


@pytest.mark.parametrize("l2, after", [(0.0, 0), (0.0, 3), (1e-2, 2)])
def test_one_step_from_carried_state_matches(small_problem, l2, after):
    """Both packages step from the same fp64 state (carried by
    convert.py): every field within 1e-9, solver_it equal."""
    A, b, x0 = small_problem
    jl, states = _jax_run(A, b, x0, l2, after + 1)
    st, st_j = states[after], jax.device_get(states[after + 1])
    loss = LogisticRegression(A, b, dtype=np.float64, l2=l2)
    st_t = tk.krylov_step(loss.data, loss.b_t,
                          krylov_state_from_numpy(jax.device_get(st)),
                          l2=l2, accum_dtype=torch.float64, **KW)
    assert int(st_t.solver_it) == int(st_j.solver_it)
    for f in tk.KrylovState._fields:
        if f in PAIRS.values() or f == "solver_it":
            continue
        got, want = getattr(st_t, f).numpy(), getattr(st_j, f)
        if f in PAIRS:
            got = got + getattr(st_t, PAIRS[f]).numpy()
            want = want + getattr(st_j, PAIRS[f])
        assert _rel_err(got, want) < 1e-9, f


@pytest.mark.parametrize("want_dense", [True, False])
def test_fp64_trajectory_matches_jax(small_problem, want_dense):
    """30 iterations through the run loop: the losses agree to ~1e-11."""
    A, b, x0 = small_problem
    _, states = _jax_run(A, b, x0, 0.0, 30, want_dense=want_dense)
    want = [float(s.value) + float(s.value_lo) for s in states]
    loss = LogisticRegression(A, b, dtype=np.float64, want_dense=want_dense)
    alg = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0)
    tr = alg.run(x0, it_max=30)
    assert list(tr.its) == list(range(31))
    got = [loss.value(x) for x in tr.iterates()]
    np.testing.assert_allclose(got, want, rtol=1e-11)
    assert tr.solver_its[:6] == [int(s.solver_it) for s in states[:6]]
    assert loss.f_opt == pytest.approx(min(want), rel=1e-11)


def test_fp32_path_reaches_fp64_optimum(small_problem):
    """fp32 storage with compensated value pairs reaches the fp64 optimum
    within 1e-8 (every iterate re-evaluated exactly on the host)."""
    A, b, x0 = small_problem
    _, states = _jax_run(A, b, x0, 0.0, 40)
    f64 = float(states[-1].value) + float(states[-1].value_lo)
    loss = LogisticRegression(A, b, dtype=np.float32)
    alg = CubicKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0)
    tr = alg.run(x0, it_max=40)
    assert alg.state.x.dtype == torch.float32
    fs = [_f64(A, b, x) for x in tr.iterates()]
    assert np.all(np.isfinite(fs)) and len(fs) == 41
    assert min(fs) - f64 < 1e-8


def test_dense_and_sparse_branches_give_the_same_step(sparse_problem):
    A, b, x0 = sparse_problem
    out = []
    for want_dense in (True, False):
        loss = LogisticRegression(A, b, dtype=np.float64,
                                  want_dense=want_dense)
        assert (loss.data.dense is not None) == want_dense
        st = tk.initial_state(loss, x0, 1e-3, tk.KrylovState)
        for _ in range(2):
            st = tk.krylov_step(loss.data, loss.b_t, st, l2=0.0,
                                accum_dtype=torch.float64, **KW)
        out.append(st)
    assert int(out[0].solver_it) == int(out[1].solver_it)
    for f in ("x", "Ax", "value", "reg_coef", "r0", "grad_norm"):
        assert _rel_err(getattr(out[0], f), getattr(out[1], f)) < 1e-10, f
