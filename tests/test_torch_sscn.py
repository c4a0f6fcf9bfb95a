"""The port's SSCN (krylov_crn_tpu_torch/solvers/sscn.py), its column
panels (ops/coords.py) and the oracle's coordinate partials against the
JAX package on the CPU, in fp64. The JAX package draws coordinates with
``jax.random.choice`` from a key in its state; the tests feed the port the
same index vectors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.models.logistic import logreg_partials as jpartials
from krylov_crn_tpu.ops.coords import gather_columns_dense as jgather
from krylov_crn_tpu.solvers import sscn as js
from krylov_crn_tpu_torch import SSCN, LogisticRegression
from krylov_crn_tpu_torch.convert import sscn_state_from_numpy
from krylov_crn_tpu_torch.models.logistic import logreg_partials
from krylov_crn_tpu_torch.ops.coords import gather_columns_dense
from krylov_crn_tpu_torch.solvers import sscn as ts

CPU = "cpu"  # the library's default device is the card

M = 12
STEP_KW = dict(beta=0.5, solver_it_max=100, ls_max=200, reg_ceil=1e6)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _jax_indices(key, d, m):
    """The next step's coordinates as jax's sscn_step draws them."""
    key, sub = jax.random.split(key)
    return key, np.array(jax.random.choice(sub, d, shape=(m,),
                                           replace=False), np.int64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gather_columns_dense_bitwise(sparse_problem, dtype):
    """The panel equals the JAX package's bit for bit (each entry is one
    stored value, scattered once)."""
    A, b, _ = sparse_problem
    I = np.random.default_rng(0).choice(A.shape[1], 40, replace=False)
    want = np.asarray(jgather(JLoss(A, b, dtype=dtype).data,
                              jnp.asarray(I, jnp.int32)))
    got = gather_columns_dense(LogisticRegression(A, b, dtype=dtype, device=CPU).data,
                               torch.from_numpy(I)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(got, A[:, I].toarray().astype(dtype))


@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_logreg_partials_match_jax(sparse_problem, l2):
    """(g_I, H_I, B) at rtol 1e-12, and the oracle's partial methods."""
    A, b, x0 = sparse_problem
    rng = np.random.default_rng(1)
    x = x0 + 0.1 * rng.standard_normal(x0.shape)
    I = rng.choice(A.shape[1], M, replace=False)
    jl = JLoss(A, b, dtype=np.float64, l2=l2)
    Ax = A @ x
    gj, Hj, Bj = jpartials(jl.data, jl.b, jnp.asarray(Ax), jnp.asarray(x),
                           jnp.asarray(I, jnp.int32), l2=l2)
    loss = LogisticRegression(A, b, dtype=np.float64, l2=l2, device=CPU)
    g, H, B = logreg_partials(loss.data, loss.b_t, torch.from_numpy(Ax),
                              torch.from_numpy(x), torch.from_numpy(I), l2=l2)
    assert _rel_err(g.numpy(), gj) < 1e-12
    assert _rel_err(H.numpy(), Hj) < 1e-12
    assert np.array_equal(B.numpy(), np.asarray(Bj))
    assert _rel_err(loss.partial_gradient(x, I).numpy(), gj) < 1e-12
    assert _rel_err(loss.partial_hessian(x, I).numpy(), Hj) < 1e-12
    # the incremental margins update Ax += A[:, I] delta
    delta = rng.standard_normal(M)
    loss.update_mat_vec_product(Ax, delta, I)
    want = Ax + A[:, I] @ delta
    assert _rel_err(loss.mat_vec_product(x).numpy(), want) < 1e-12


@pytest.mark.parametrize("l2, after", [(0.0, 0), (0.0, 3), (1e-2, 2)])
def test_one_step_from_carried_state_matches(sparse_problem, l2, after):
    """Both packages step from the same fp64 state with the same
    coordinates: every field at rtol 1e-11, solver_it equal."""
    A, b, x0 = sparse_problem
    jl = JLoss(A, b, dtype=np.float64, l2=l2)
    ja = js.SSCN(loss=jl, reg_coef=1e-3, subspace_dim=M, tqdm=False)
    st = ja.init_state(jnp.asarray(x0), 0)
    kw = dict(STEP_KW, m=M, l2=l2, accum_dtype=jnp.float64)
    for _ in range(after):
        st = js.sscn_step(jl.data, jl.b, st, **kw)
    _, I = _jax_indices(st.key, A.shape[1], M)
    st_j = jax.device_get(js.sscn_step(jl.data, jl.b, st, **kw))
    loss = LogisticRegression(A, b, dtype=np.float64, l2=l2, device=CPU)
    st_t = ts.sscn_step(loss.data, loss.b_t,
                        sscn_state_from_numpy(jax.device_get(st), device=CPU),
                        torch.from_numpy(I), l2=l2,
                        accum_dtype=torch.float64, **STEP_KW)
    assert int(st_t.solver_it) == int(st_j.solver_it)
    for f in ts.SSCNState._fields:
        if f in ("solver_it", "value_lo", "f_best_lo"):
            continue
        assert _rel_err(getattr(st_t, f).numpy(), getattr(st_j, f)) < 1e-11, f


def test_trajectory_with_jax_indices(sparse_problem):
    """8 steps, the port fed JAX's index sequence: loss values at rtol
    1e-10, equal solver_it."""
    A, b, x0 = sparse_problem
    jl = JLoss(A, b, dtype=np.float64)
    ja = js.SSCN(loss=jl, reg_coef=1e-3, subspace_dim=M, tqdm=False)
    st = ja.init_state(jnp.asarray(x0), 42)
    loss = LogisticRegression(A, b, dtype=np.float64, device=CPU)
    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=M)
    st_t = alg.init_state(x0, 42)
    kw = dict(STEP_KW, accum_dtype=jnp.float64)
    vj, vt = [], []
    for _ in range(8):
        _, I = _jax_indices(st.key, A.shape[1], M)
        st = js.sscn_step(jl.data, jl.b, st, m=M, l2=0.0, **kw)
        st_t = ts.sscn_step(loss.data, loss.b_t, st_t, torch.from_numpy(I),
                            accum_dtype=torch.float64, **STEP_KW)
        vj.append(float(st.value))
        vt.append(float(st_t.value))
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    assert int(st_t.solver_it) == int(st.solver_it)
    assert vt[-1] < float(ja.init_state(jnp.asarray(x0), 42).value)


def _independent_fstar(A, b):
    """f* by scipy L-BFGS on an independently written fp64 objective."""
    from scipy.optimize import minimize

    Ad = A.toarray()
    b01 = (np.asarray(b) + 1) / 2
    n = Ad.shape[0]

    def f(x):
        Ax = Ad @ x
        ls = np.where(Ax < 0, Ax - np.log1p(np.exp(Ax)),
                      -np.log1p(np.exp(-Ax)))
        return np.mean((1 - b01) * Ax - ls)

    def grad(x):
        return Ad.T @ (1 / (1 + np.exp(-(Ad @ x))) - b01) / n

    res = minimize(f, np.zeros(Ad.shape[1]), jac=grad, method="L-BFGS-B",
                   options=dict(maxiter=5000, ftol=1e-16, gtol=1e-12))
    return res.fun


def test_sscn_converges(small_problem):
    """The port's SSCN with its own generator, as the JAX package's
    test_sscn_converges (m = 20, within 1e-4 of f*, a non-increasing
    loss). 100 iterations instead of 400: the gap passes 1e-4 near
    iteration 50, and converged steps cost ~20 host-sequenced trials each
    on the CPU."""
    A, b, x0 = small_problem
    fstar = _independent_fstar(A, b)
    loss = LogisticRegression(A, b, dtype=np.float64, device=CPU)
    alg = SSCN(loss=loss, reg_coef=1e-3, subspace_dim=20, label="sscn")
    trace = alg.run(x0=x0, it_max=100)
    alg.compute_loss_of_iterates()
    vals = np.asarray(trace.loss_vals)
    assert (np.diff(vals) <= 1e-12).all()
    assert vals[-1] - fstar < 1e-4
    assert len(trace.solver_its) == len(trace.its)


def test_coordinates_from_seeded_cpu_generator(small_problem):
    """Two runs with one seed draw the same coordinates (and so reach the
    same bits); another seed draws others."""
    A, b, x0 = small_problem
    out = []
    for seed in (7, 7, 8):
        alg = SSCN(loss=LogisticRegression(A, b, dtype=np.float64, device=CPU),
                   reg_coef=1e-3, subspace_dim=10, seeds=[seed])
        alg.run(x0=x0, it_max=5)
        out.append(alg.state.x)
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
