"""The port's logistic oracle (krylov_crn_tpu_torch/models/logistic.py)
against the JAX package's in fp64: value (with the running-best record),
gradient, HVP (exact and gradient-difference), dense Hessian, the margin
cache and the smoothness constants, on the dense and the sparse branch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu_torch import LogisticRegression
from krylov_crn_tpu_torch.models.base import Oracle, Regularizer

CPU = "cpu"  # the library's default device is the card


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module", params=[(True, 0.0), (False, 0.01)],
                ids=["dense", "sparse-l2"])
def pair(request, small_problem):
    want_dense, l2 = request.param
    A, b, x0 = small_problem
    ours = LogisticRegression(A, b, dtype=np.float64, l2=l2,
                              want_dense=want_dense, device=CPU)
    theirs = JLoss(A, b, dtype=np.float64, l2=l2, want_dense=want_dense)
    assert (ours.data.dense is not None) == want_dense
    rng = np.random.default_rng(11)
    x = x0 + 0.3 * rng.standard_normal(x0.shape)
    v = rng.standard_normal(x0.shape)
    return ours, theirs, x, v


def test_value_and_running_best(pair):
    ours, theirs, x, _ = pair
    f = ours.value(x)
    assert f == pytest.approx(theirs.value(jnp.asarray(x)), rel=1e-13)
    assert ours.f_opt == f
    np.testing.assert_array_equal(ours.x_opt.numpy(), x)
    ours.value(x * 50.0)  # worse: the record keeps the better point
    assert ours.f_opt == f


def test_gradient(pair):
    ours, theirs, x, _ = pair
    assert _rel(ours.gradient(x), theirs.gradient(jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("grad_dif", [False, True])
def test_hvp(pair, grad_dif):
    ours, theirs, x, v = pair
    kw = dict(grad_dif=grad_dif, eps=1e-6 if grad_dif else None)
    got = ours.hess_vec_prod(x, v, **kw)
    want = theirs.hess_vec_prod(jnp.asarray(x), jnp.asarray(v), **kw)
    assert _rel(got, want) < (1e-8 if grad_dif else 1e-12)


def test_dense_hessian(pair):
    ours, theirs, x, v = pair
    if ours.data.dense is None:
        with pytest.raises(ValueError):
            ours.hessian(x)
        return
    H = ours.hessian(x)
    assert _rel(H, theirs.hessian(jnp.asarray(x))) < 1e-12
    assert _rel(H @ torch.from_numpy(v), ours.hess_vec_prod(x, v)) < 1e-12


def test_smoothness_constants(pair):
    ours, theirs, _, _ = pair
    for name in ("smoothness", "max_smoothness", "average_smoothness",
                 "hessian_lipschitz"):
        assert getattr(ours, name) == pytest.approx(
            getattr(theirs, name), rel=1e-9), name


def test_mat_vec_cache(small_problem):
    A, b, x0 = small_problem
    loss = LogisticRegression(A, b, dtype=np.float64, device=CPU)
    x = torch.from_numpy(x0)
    Ax = loss.mat_vec_product(x)
    assert loss.mat_vec_product(x) is Ax
    assert loss.mat_vec_product(x0.copy()) is Ax  # equal values hit
    assert loss.mat_vec_product(x0 + 1.0) is not Ax
    loss.reset()
    assert loss.x_last is None


def test_base_helpers_and_regularizer():
    x = np.array([3.0, -4.0, 0.5])
    y = np.array([1.0, 2.0, -2.0])
    assert Oracle.norm(x) == pytest.approx(np.linalg.norm(x))
    assert Oracle.inner_prod(x, y) == pytest.approx(x @ y)
    np.testing.assert_allclose(Oracle.outer_prod(x, y).numpy(),
                               np.outer(x, y))
    assert Oracle.is_equal(x, x.copy()) and not Oracle.is_equal(x, y)
    assert Oracle.is_equal(None, None) and not Oracle.is_equal(x, None)
    assert not Oracle.is_equal(x, x[:2])
    reg = Regularizer(l1=0.5, l2=0.2)
    assert float(reg(x)) == pytest.approx(0.5 * 7.5 + 0.1 * (x @ x))
    lr = 0.7
    want = np.sign(x) * np.maximum(np.abs(x) - 0.5 * lr, 0) / (1 + lr * 0.2)
    np.testing.assert_allclose(reg.prox(x, lr).numpy(), want)
    o = Oracle(l1=0.1, l2=0.3, l2_in_prox=True)
    assert o.l2 == 0.0 and o.regularizer.l2 == 0.3
    o.set_seed(3)
    assert o.rng.integers(1 << 30) == np.random.default_rng(3).integers(
        1 << 30)
    with pytest.raises(ValueError):
        Oracle(l2=-1.0)
