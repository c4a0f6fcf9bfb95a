"""The subproblem kernel of a Gram Krylov step (csrc/subproblem.cu: the
tridiagonal eigh and the secular Newton of every line-search candidate in
one launch). On the CPU its scalar algorithm, emulated in numpy
(``tridiag_secular_emulated``), is held against the JAX package's
``tridiag_eigh`` and vmapped ``secular_newton`` in fp64 and fp32; the test
marked ``cuda`` holds the kernel to the emulation bit for bit.

Tolerances: theta within 16 eps ||T||_2 (two backward-stable eigen-solves);
lambda within 1e-10 relative in fp64 and 1e-5 in fp32 (or, in fp32, within
the Newton's absolute stop xtol = 1e-8, where lambda is as small as 1e-5);
Newton counts within
one in fp64. In fp32 the order of the secular sums (XLA's in the JAX
package, index order in the kernel) decides the last Newton steps: counts
within ``FP32_ITS_GAP``, unless one side runs to ``it_max`` (a two-cycle
between adjacent floats), and where the JAX package's lambda is NaN (its
iterate landed on the pole of an indefinite T) the kernel's lies at the
pole within the lambda tolerance (either side's iterate may land on it and
divide by zero). The step S, which does not depend on eigenvector signs,
agrees wherever both lambdas are finite, relative to its largest entry,
within the lambda tolerance plus the absolute errors of lambda and theta
over the nearest |theta_i + lambda| (first-order perturbation of the
coefficients c_i / (theta_i + lambda), large only near the pole)."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import GramKrylov, LogisticRegression
from krylov_crn_tpu_torch.ops import subproblem as ts
from krylov_crn_tpu_torch.solvers import krylov_gram as tk

CPU = "cpu"  # the library's default device is the card
L = 21
IT_MAX = 100
XTOL = 1e-8
LAM_TOL = {np.float64: 1e-10, np.float32: 1e-5}
# fp32 Newton counts: the last steps hover within a few ulps of the root,
# and when |step| first falls below xtol is rounding's decision (up to 6
# steps apart on 240 random fp32 tridiagonals against the JAX package)
FP32_ITS_GAP = 8


def _tridiag(seed, m=10, shift=0.0, zero_tail=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    alphas = np.abs(rng.standard_normal(m)) * 0.3 + shift
    betas = np.abs(rng.standard_normal(m - 1)) * 0.1
    if zero_tail:  # a breakdown-masked Lanczos block: c = 0 modes
        alphas[-zero_tail:] = 0.0
        betas[-zero_tail:] = 0.0
    return alphas.astype(dtype), betas.astype(dtype)


def _regs(reg, dtype):
    return (reg * 0.5 * 2.0 ** np.arange(L)).astype(dtype)


def _jax(alphas, betas, g_norm, regs, r0, it_max=IT_MAX):
    # imported here: the card's machine, which runs the cuda tests, has no
    # jax
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.ops import subproblem as js

    theta, Q = js.tridiag_eigh(jnp.asarray(alphas), jnp.asarray(betas))
    c = jnp.asarray(g_norm, theta.dtype) * Q[0, :]
    r0 = jnp.asarray(r0, theta.dtype)
    lam, its = jax.jit(jax.vmap(lambda M: js.secular_newton(
        theta, c, M, r0, xtol=XTOL, it_max=it_max)))(jnp.asarray(regs))
    return tuple(np.asarray(v) for v in (theta, Q, lam, its))


def _step(theta, Q, g_norm, lam):
    """S = U Q^T in fp64 from one side's results (sign-invariant)."""
    theta, Q, lam = (np.asarray(v, np.float64) for v in (theta, Q, lam))
    c = float(g_norm) * Q[0, :]
    denom = theta[None, :] + lam[:, None]
    U = np.where(c[None, :] != 0,
                 -c[None, :] / np.where(c[None, :] != 0, denom, 1.0), 0.0)
    return U @ Q.T


def _step_tol(theta, lams, lam_tol, lam_atol, theta_err):
    """Per candidate, the relative error the step's coefficients
    c_i / (theta_i + lambda) may carry (first order): lambda's tolerance,
    plus lambda's and theta's absolute errors over the nearest
    |theta_i + lambda|, which is small near the pole."""
    theta = np.asarray(theta, np.float64)
    lams = np.asarray(lams, np.float64)
    near = np.min(np.abs(theta[None, :] + lams[:, None]), axis=1,
                  initial=np.inf)
    return lam_tol + (lam_tol * np.abs(lams) + lam_atol + theta_err) / near


def _hold(alphas, betas, g_norm, regs, r0, it_max=IT_MAX):
    """The emulation against the JAX package on one input, at the
    module's tolerances; returns the emulation's results."""
    dt = alphas.dtype.type
    got = ts.tridiag_secular_emulated(alphas, betas, g_norm, regs, r0,
                                      xtol=XTOL, it_max=it_max)
    want = _jax(alphas, betas, g_norm, regs, r0, it_max)
    theta, Q, lam, its = got
    assert theta.dtype == Q.dtype == lam.dtype == alphas.dtype
    assert its.dtype == np.int64 and its.shape == lam.shape == (len(regs),)
    T = (np.diag(alphas.astype(np.float64))
         + np.diag(betas.astype(np.float64), 1)
         + np.diag(betas.astype(np.float64), -1))
    eps = np.finfo(dt).eps
    bound = 16 * eps * max(np.linalg.norm(T, 2), np.finfo(dt).tiny)
    assert np.max(np.abs(theta.astype(np.float64) - want[0])) <= bound
    tol = LAM_TOL[dt]
    fin = np.isfinite(lam) & np.isfinite(want[2])
    if dt is np.float32:
        # the hard case: an iterate that lands on the pole lam = -theta_min
        # divides by zero there (NaN); the other side's stops a rounding
        # away, on either side
        pole = -float(want[0][0])
        for side in (lam, want[2]):
            off = ~fin & np.isfinite(side)
            np.testing.assert_allclose(side[off], pole, rtol=tol, atol=0)
    else:
        assert fin.all()
    # fp32: or within the Newton's own absolute stop, xtol, where lambda
    # is small
    atol = XTOL if dt is np.float32 else 0.0
    np.testing.assert_allclose(lam[fin], want[2][fin], rtol=tol, atol=atol)
    gap = np.abs(its - want[3])[fin]
    if dt is np.float32:
        capped = ((its == it_max) | (want[3] == it_max))[fin]
        assert (gap[~capped] <= FP32_ITS_GAP).all(), (its, want[3])
    else:
        assert (gap <= 1).all(), (its, want[3])
    S, S_j = (_step(theta, Q, g_norm, lam[fin]),
              _step(*want[:2], g_norm, want[2][fin]))
    err = np.max(np.abs(S - S_j), axis=1, initial=0.0)
    rel = _step_tol(want[0], want[2][fin], tol, atol, bound)
    assert (err <= rel * max(np.abs(S_j).max(initial=0.0), 1e-300)).all()
    return got


CASES = [
    dict(seed=0, g_norm=0.3, reg=1e-3, r0=0.1),
    dict(seed=1, g_norm=1e-4, reg=1e-2, r0=1e-3),
    dict(seed=2, g_norm=2.0, reg=5.0, r0=0.1),
    dict(seed=3, g_norm=0.05, reg=1e-3, r0=0.1, shift=-0.4),  # indefinite
    dict(seed=4, g_norm=0.5, reg=1e-3, r0=0.1, zero_tail=4),  # c = 0 modes
    dict(seed=5, g_norm=0.3, reg=1e-3, r0=0.1, it_max=3),  # capped
    dict(seed=6, g_norm=0.3, reg=1e-3, r0=0.1, m=20),  # the f* run's m
    dict(seed=7, g_norm=0.3, reg=1e-3, r0=0.1, m=1),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax_on_random_tridiagonals(case, dtype):
    case = dict(case)
    alphas, betas = _tridiag(case.pop("seed"), m=case.pop("m", 10),
                             shift=case.pop("shift", 0.0),
                             zero_tail=case.pop("zero_tail", 0), dtype=dtype)
    _, Q, _, _ = _hold(alphas, betas, dtype(case["g_norm"]),
                       _regs(case["reg"], dtype), dtype(case["r0"]),
                       it_max=case.get("it_max", IT_MAX))
    if alphas[-1] == 0 and len(alphas) > 1:
        # the zero block's eigenvectors have no weight in the first row
        assert np.count_nonzero(Q[0, :] == 0) >= 4


def _lanczos_inputs(small_problem, dtype, monkeypatch, steps=8):
    """The subproblem inputs of the first ``steps`` Gram steps of the
    port's CPU run on the 400-row fixture (m=10, fp32 or fp64)."""
    A, b, x0 = small_problem
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=dtype, device=CPU),
                     reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=CPU)
    seen = []
    plain = tk.tridiag_secular

    def record(*args, **kw):
        seen.append(tuple(a.numpy().copy() for a in args))
        return plain(*args, **kw)

    monkeypatch.setattr(tk, "tridiag_secular", record)
    alg.run_fused(x0, it_max=steps, chunk=steps)
    assert len(seen) == steps
    return seen


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_emulation_matches_jax_on_lanczos_tridiagonals(small_problem, dtype,
                                                       monkeypatch):
    for alphas, betas, g_norm, regs, r0 in _lanczos_inputs(
            small_problem, dtype, monkeypatch):
        assert alphas.dtype == dtype
        _hold(alphas, betas, g_norm, regs, r0)


def test_emulation_with_zero_gradient_gives_zero_steps():
    alphas, betas = _tridiag(6)
    theta, Q, lam, its = ts.tridiag_secular_emulated(
        alphas, betas, 0.0, _regs(1e-3, np.float64), 0.1)
    assert np.isfinite(lam).all()
    assert np.all(_step(theta, Q, 0.0, lam) == 0)


def test_emulation_marks_a_failed_eigen_solve():
    """A tridiagonal QL cannot reduce (NaN on the diagonal) leaves every
    theta NaN after QL_MAX_SWEEPS sweeps, as an eigh that fails does."""
    alphas, betas = _tridiag(0)
    alphas[3] = np.nan
    theta, _, _, _ = ts.tridiag_secular_emulated(
        alphas, betas, 0.3, _regs(1e-3, np.float64), 0.1)
    assert np.isnan(theta).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype):
    alphas, betas = _tridiag(0)
    args = [torch.from_numpy(v).to(dtype) for v in (
        alphas, betas, np.asarray(0.3), _regs(1e-3, np.float64),
        np.asarray(0.1))]
    before = ts.tridiag_secular.launches
    got = ts.tridiag_secular(*args, xtol=1e-8, it_max=IT_MAX)
    want = ts.tridiag_secular_plain(*args, xtol=1e-8, it_max=IT_MAX)
    assert ts.tridiag_secular.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_emulation_on_card(cuda_device, case, dtype):
    case = dict(case)
    it_max = case.pop("it_max", IT_MAX)
    alphas, betas = _tridiag(case.pop("seed"), m=case.pop("m", 10),
                             shift=case.pop("shift", 0.0),
                             zero_tail=case.pop("zero_tail", 0), dtype=dtype)
    host = (alphas, betas, np.asarray(case["g_norm"], dtype),
            _regs(case["reg"], dtype), np.asarray(case["r0"], dtype))
    args = [torch.from_numpy(v).to(cuda_device) for v in host]
    before = ts.tridiag_secular.launches
    got = ts.tridiag_secular(*args, xtol=1e-8, it_max=it_max)
    torch.cuda.synchronize()
    assert ts.tridiag_secular.launches == before + 1
    want = ts.tridiag_secular_emulated(*host, xtol=1e-8, it_max=it_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)
    with pytest.raises(TypeError):
        ts.tridiag_secular(*(a.to(torch.float16) for a in args))
    with pytest.raises(ValueError):
        ts.tridiag_secular(args[0][:-1], *args[1:])
