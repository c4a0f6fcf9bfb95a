"""Batched secular Newton of the port against the JAX package's vmapped
while_loop, in fp64: the same lambda and the same per-candidate iteration
counts (solver_it is traced), and the same steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.ops import subproblem as js
from krylov_crn_tpu_torch.ops import subproblem as ts

L = 21


def _tridiag(seed, m=10, shift=0.0, zero_tail=0):
    rng = np.random.default_rng(seed)
    alphas = np.abs(rng.standard_normal(m)) * 0.3 + shift
    betas = np.abs(rng.standard_normal(m - 1)) * 0.1
    if zero_tail:
        # a breakdown-masked Lanczos block: zero tail
        alphas[-zero_tail:] = 0.0
        betas[-zero_tail:] = 0.0
    return alphas, betas


def _both(alphas, betas, g_norm, reg, r0, it_max=100):
    ks = np.arange(L, dtype=np.float64)
    regs = reg * 0.5 * 2.0 ** ks
    theta_j, Q_j = js.tridiag_eigh(jnp.asarray(alphas), jnp.asarray(betas))
    c_j = g_norm * Q_j[0, :]
    lam_j, its_j = jax.jit(jax.vmap(
        lambda M: js.secular_newton(theta_j, c_j, M, jnp.asarray(r0),
                                    xtol=1e-8, it_max=it_max)))(
        jnp.asarray(regs))
    theta_t, Q_t = ts.tridiag_eigh(torch.from_numpy(alphas),
                                   torch.from_numpy(betas))
    c_t = g_norm * Q_t[0, :]
    lam_t, its_t = ts.secular_newton(theta_t, c_t, torch.from_numpy(regs),
                                     torch.tensor(r0, dtype=torch.float64),
                                     xtol=1e-8, it_max=it_max)
    return (theta_j, Q_j, c_j, lam_j, its_j), (theta_t, Q_t, c_t, lam_t,
                                               its_t)


def _steps(theta, Q, c, lam):
    theta, Q, c, lam = (np.asarray(v) for v in (theta, Q, c, lam))
    denom = theta[None, :] + lam[:, None]
    U = np.where(c[None, :] != 0,
                 -c[None, :] / np.where(c[None, :] != 0, denom, 1.0), 0.0)
    return U @ Q.T


@pytest.mark.parametrize("case", [
    dict(seed=0, g_norm=0.3, reg=1e-3, r0=0.1),
    dict(seed=1, g_norm=1e-4, reg=1e-2, r0=1e-3),
    dict(seed=2, g_norm=2.0, reg=5.0, r0=0.1),
    dict(seed=3, g_norm=0.05, reg=1e-3, r0=0.1, shift=-0.4),  # indefinite
    dict(seed=4, g_norm=0.5, reg=1e-3, r0=0.1, zero_tail=4),  # masked tail
    dict(seed=5, g_norm=0.3, reg=1e-3, r0=0.1, it_max=3),  # capped
])
def test_secular_newton_matches_vmapped_jax(case):
    case = dict(case)
    it_max = case.pop("it_max", 100)
    alphas, betas = _tridiag(case.pop("seed"), shift=case.pop("shift", 0.0),
                             zero_tail=case.pop("zero_tail", 0))
    (th_j, Q_j, c_j, lam_j, its_j), (th_t, Q_t, c_t, lam_t, its_t) = _both(
        alphas, betas, it_max=it_max, **case)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(its_t.numpy(), np.asarray(its_j))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-12)
    # steps do not depend on the eigenvector signs
    S_t = _steps(th_t.numpy(), Q_t.numpy(), c_t.numpy(), lam_t.numpy())
    S_j = _steps(th_j, Q_j, c_j, lam_j)
    np.testing.assert_allclose(S_t, S_j, rtol=1e-10,
                               atol=1e-12 * np.abs(S_j).max())


def test_secular_newton_zero_gradient_is_finite():
    alphas, betas = _tridiag(6)
    _, (theta, Q, c, lam, its) = _both(alphas, betas, g_norm=0.0, reg=1e-3,
                                       r0=0.1)
    assert torch.isfinite(lam).all()
    assert np.all(_steps(theta, Q, c, lam) == 0)


def test_sym_eigh_on_cpu_is_the_jax_package_eigh():
    """On the CPU ``sym_eigh`` calls the LAPACK the JAX package's ``eigh``
    calls there: the same bits in fp64, also on the shape SSCN hands it,
    a Hessian whose sampled columns are mostly empty (exact zero rows)."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((300, 120)) * (rng.random((300, 120)) < 0.1)
    B[:, rng.random(120) < 0.8] = 0.0
    H = B.T @ (B * rng.random(300)[:, None])
    H = (H + H.T) / 2
    theta, Q = ts.sym_eigh(torch.from_numpy(H))
    jtheta, jQ = jnp.linalg.eigh(jnp.asarray(H))
    assert theta.dtype == torch.float64
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    np.testing.assert_array_equal(Q.numpy(), np.asarray(jQ))
