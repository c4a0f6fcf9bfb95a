"""The two kernels of the CRN "full" and SSCN steps: the dense symmetric
eigh (csrc/eigh.cu, a parallel cyclic Jacobi) and the secular Newton over a
dense spectrum (csrc/subproblem.cu's ``eig_secular``). On the CPU each
kernel's walk, emulated in numpy (``sym_eigh_emulated``,
``eig_secular_emulated``), is held against the port's plain versions
(LAPACK's evd through scipy; ``secular_newton``) and against the JAX
package's ``jnp.linalg.eigh`` and ``secular_newton``; the tests marked
``cuda`` hold the kernels to their emulations bit for bit.

Within a repeated eigenvalue any orthonormal basis is right, so Q is held
through what does not depend on the basis: the residual
||H Q - Q diag(theta)|| / ||H||_F and ||Q^T Q - I||_F within RES_EPS n eps,
the sorted thetas within THETA_EPS eps ||H||_F, and the cubic step s and
lambda that ``cubic_solve_eigh`` builds from each decomposition: lambda
within LAM_TOL relative, s within LAM_TOL of its norm plus the thetas'
error over the gap between the smallest |theta + lambda| (first-order
perturbation of c_i / (theta_i + lambda)). Jacobi keeps the exact zeros of
an empty row exact, where LAPACK leaves them at +-1e-16 ||H||."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.ops import eigh as te
from krylov_crn_tpu_torch.ops import subproblem as ts

CPU = "cpu"  # the library's default device is the card
RES_EPS = 4  # residual and orthogonality, in units of n eps
THETA_EPS = 16  # sorted thetas, in units of eps ||H||_F
LAM_TOL = {np.float64: 1e-10, np.float32: 1e-4}
XTOL = 1e-8
IT_MAX = 100


def _random(n, seed, dtype):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    return ((G + G.T) / 2).astype(dtype)


def _zero_rows(n, seed, dtype):
    """An SSCN-like Hessian: B^T diag(w) B / rows with most sampled columns
    empty, so most rows and columns of H are exactly zero."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((200, n)) * (rng.random(n) < 0.2)[None, :]
    w = rng.random(200) * 0.25
    return ((B * w[:, None]).T @ B / 200).astype(dtype)


def _repeated(n, seed, dtype, k=6):
    """A repeated eigenvalue (2.0, k times) beside random ones."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.r_[np.full(k, 2.0), rng.random(n - k)]
    H = (Q * d) @ Q.T
    return ((H + H.T) / 2).astype(dtype)


MATRICES = {"random8": lambda dt: _random(8, 0, dt),
            "random33": lambda dt: _random(33, 1, dt),
            "random70": lambda dt: _random(70, 2, dt),
            "zero_rows": lambda dt: _zero_rows(40, 3, dt),
            "repeated": lambda dt: _repeated(30, 4, dt)}


def _jax_eigh(H):
    # imported here: the card's machine, which runs the cuda tests, has no
    # jax
    import jax.numpy as jnp

    theta, Q = jnp.linalg.eigh(jnp.asarray(H))
    return np.asarray(theta), np.asarray(Q)


def _hold_decomposition(H, theta, Q):
    """Residual, orthogonality and the dtype of one decomposition."""
    dt = H.dtype
    eps = float(np.finfo(dt).eps)
    n = H.shape[0]
    H64, Q64, th64 = (np.asarray(v, np.float64) for v in (H, Q, theta))
    assert theta.dtype == Q.dtype == dt and Q.shape == (n, n)
    norm = max(np.linalg.norm(H64), 1e-300)
    res = np.linalg.norm(H64 @ Q64 - Q64 * th64) / norm
    orth = np.linalg.norm(Q64.T @ Q64 - np.eye(n))
    assert res <= RES_EPS * n * eps, res
    assert orth <= RES_EPS * n * eps, orth
    assert np.all(np.diff(th64) >= 0)


def _step(theta, Q, g, reg, r0, dt):
    """(lambda, s) of ``cubic_solve_eigh`` from one decomposition."""
    t = lambda v: torch.from_numpy(np.array(v, dt))
    sol = ts.cubic_solve_eigh(t(theta), t(Q), t(g), reg, r0, xtol=XTOL,
                              it_max=IT_MAX)
    return float(sol.r), sol.s.numpy().astype(np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(MATRICES))
def test_emulation_against_lapack_and_jax(name, dtype):
    H = MATRICES[name](dtype)
    n = H.shape[0]
    theta, Q = te.sym_eigh_emulated(H)
    assert 0 < te.sym_eigh_emulated.sweeps < te.MAX_SWEEPS
    _hold_decomposition(H, theta, Q)
    eps = float(np.finfo(dtype).eps)
    norm = np.linalg.norm(H.astype(np.float64))
    th_lapack, Q_lapack = (v.numpy() for v in te.sym_eigh_plain(
        torch.from_numpy(H)))
    th_jax, Q_jax = _jax_eigh(H)
    for ref in (th_lapack, th_jax):
        err = np.max(np.abs(theta.astype(np.float64) - ref))
        assert err <= THETA_EPS * eps * norm, err
    # the cubic step from each decomposition
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n) * 0.1
    lam_tol = LAM_TOL[dtype]
    th_err = THETA_EPS * eps * norm
    for reg, r0 in ((1e-3, 0.1), (1.0, 1e-3)):
        lam, s = _step(theta, Q, g, reg, r0, dtype)
        for th_r, Q_r in ((th_lapack, Q_lapack), (th_jax, Q_jax)):
            lam_r, s_r = _step(th_r, Q_r, g, reg, r0, dtype)
            assert abs(lam - lam_r) <= lam_tol * abs(lam_r) + XTOL
            near = np.min(np.abs(th_r + lam_r))
            s_tol = (lam_tol + (lam_tol * abs(lam_r) + XTOL + th_err)
                     / near) * np.linalg.norm(s_r)
            assert np.linalg.norm(s - s_r) <= s_tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_emulation_keeps_exact_zeros(dtype):
    """The empty rows' eigenvalues are exact zeros (LAPACK's are +-1e-16
    off), so min(theta), which the Newton's pole guard reads, is 0 and
    not a rounding below it; their eigenvectors are unit vectors of the
    empty rows."""
    H = _zero_rows(40, 3, dtype)
    empty = np.flatnonzero(~np.any(H != 0, axis=0))
    assert len(empty) > 20
    theta, Q = te.sym_eigh_emulated(H)
    zeros = np.flatnonzero(theta == 0)
    assert len(zeros) >= len(empty) and theta[0] >= 0
    for i in empty:
        col = np.flatnonzero(Q[i, :])
        assert len(col) == 1 and abs(Q[i, col[0]]) == 1


def test_emulation_pads_an_odd_n_without_an_extra_eigenvalue():
    """n = 7 with eigenvalues all above 1: the decoupled pad row must not
    add a zero to theta."""
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.standard_normal((7, 7)))
    H = (Q * (1.0 + rng.random(7))) @ Q.T
    theta, _ = te.sym_eigh_emulated((H + H.T) / 2)
    assert theta.shape == (7,) and theta.min() > 1.0


def test_emulation_marks_a_failed_eigh():
    """A matrix that cannot converge (NaN) gives NaN thetas after
    MAX_SWEEPS sweeps, as an eigh that fails does."""
    H = _random(6, 0, np.float64)
    H[2, 1] = np.nan
    theta, _ = te.sym_eigh_emulated(H)
    assert np.isnan(theta).all()
    assert te.sym_eigh_emulated.sweeps == te.MAX_SWEEPS


def test_emulation_reads_the_lower_triangle():
    H = _random(9, 6, np.float64)
    upper_garbage = H + np.triu(np.full_like(H, 7.0), 1)
    for got, want in zip(te.sym_eigh_emulated(upper_garbage),
                         te.sym_eigh_emulated(H)):
        assert np.array_equal(got, want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    H = torch.from_numpy(_random(12, 7, np.float64))
    before = te.sym_eigh.launches
    got = te.sym_eigh(H)
    want = te.sym_eigh_plain(H)
    assert te.sym_eigh.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ts.sym_eigh is te.sym_eigh  # the solvers' import


# ---- eig_secular: the Newton over a dense spectrum ----

def _spectrum(m, seed, dtype, shift=0.0, zeros=0):
    rng = np.random.default_rng(seed)
    theta = np.sort(rng.random(m) + shift).astype(dtype)
    c = (rng.standard_normal(m) * 0.1).astype(dtype)
    c[:zeros] = 0
    return theta, c


SPECTRA = [dict(m=10, seed=0), dict(m=33, seed=1, zeros=5),
           dict(m=70, seed=2, shift=-0.3),  # indefinite: lo > 0
           dict(m=300, seed=3, zeros=200),  # mostly empty, as SSCN's
           dict(m=1, seed=4)]


def _jax_secular(theta, c, regs, r0):
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.ops import subproblem as js

    th, cc = jnp.asarray(theta), jnp.asarray(c)
    r0 = jnp.asarray(r0, th.dtype)
    lam, its = jax.jit(jax.vmap(lambda M: js.secular_newton(
        th, cc, M, r0, xtol=XTOL, it_max=IT_MAX)))(jnp.asarray(regs))
    return np.asarray(lam), np.asarray(its)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SPECTRA)
def test_secular_emulation_against_plain_and_jax(case, dtype):
    """Every candidate's root within LAM_TOL (fp64 1e-10; fp32 its
    relative tolerance or the Newton's own stop xtol) and its Newton count
    within one in fp64 (fp32: the order of the sums decides the last
    steps, within 8 unless one side runs to it_max)."""
    theta, c = _spectrum(case["m"], case["seed"], dtype,
                         case.get("shift", 0.0), case.get("zeros", 0))
    regs = (1e-3 * 0.5 * 2.0 ** np.arange(6)).astype(dtype)
    r0 = np.asarray([0.1], dtype)
    lam, its = ts.eig_secular_emulated(theta, c, regs, r0, xtol=XTOL,
                                       it_max=IT_MAX)
    assert lam.dtype == dtype and its.dtype == np.int64
    t = lambda v: torch.from_numpy(np.asarray(v))
    lam_p, its_p = (v.numpy() for v in ts.secular_newton(
        t(theta), t(c), t(regs), t(r0).reshape(()), xtol=XTOL,
        it_max=IT_MAX))
    lam_j, its_j = _jax_secular(theta, c, regs, r0[0])
    tol = 1e-10 if dtype == np.float64 else 1e-5
    atol = 0.0 if dtype == np.float64 else XTOL
    gap = 1 if dtype == np.float64 else 8
    for lam_r, its_r in ((lam_p, its_p), (lam_j, its_j)):
        np.testing.assert_allclose(lam, lam_r, rtol=tol, atol=atol)
        capped = (its == IT_MAX) | (its_r == IT_MAX)
        assert (np.abs(its - its_r)[~capped] <= gap).all(), (its, its_r)


def test_secular_wrapper_takes_the_plain_version_on_the_cpu():
    theta, c = _spectrum(20, 9, np.float64)
    args = [torch.from_numpy(v) for v in (theta, c, np.array([1e-3, 1.0]),
                                          np.array([0.1]))]
    before = ts.eig_secular.launches
    lam, its = ts.eig_secular(*args, xtol=XTOL, it_max=IT_MAX)
    want = ts.secular_newton(*args[:3], args[3].reshape(()), xtol=XTOL,
                             it_max=IT_MAX)
    assert ts.eig_secular.launches == before
    assert torch.equal(lam, want[0]) and torch.equal(its, want[1])


def test_secular_emulation_with_zero_weights_stays_at_the_start():
    """All c = 0: every term drops out, phi = lam^2, so Newton halves lam
    from r0 until the step is below xtol, as the JAX loop does."""
    theta = np.linspace(0.1, 1.0, 40)
    lam, its = ts.eig_secular_emulated(theta, np.zeros(40), np.array([1.0]),
                                       np.array([0.1]))
    lam_j, its_j = _jax_secular(theta, np.zeros(40), np.array([1.0]), 0.1)
    assert np.array_equal(lam, lam_j) and np.array_equal(its, its_j)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(MATRICES))
def test_eigh_kernel_matches_emulation_on_card(cuda_device, name, dtype):
    H = MATRICES[name](dtype)
    sweeps = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = te.sym_eigh.launches
    theta, Q = te.sym_eigh(torch.from_numpy(H).to(cuda_device),
                           sweeps=sweeps)
    torch.cuda.synchronize()
    assert te.sym_eigh.launches == before + 1
    want = te.sym_eigh_emulated(H)
    np.testing.assert_array_equal(theta.cpu().numpy(), want[0])
    np.testing.assert_array_equal(Q.cpu().numpy(), want[1])
    assert int(sweeps.item()) == te.sym_eigh_emulated.sweeps
    with pytest.raises(TypeError):
        te.sym_eigh(torch.from_numpy(H).to(cuda_device).half())
    with pytest.raises(ValueError):
        te.sym_eigh(torch.from_numpy(H).to(cuda_device)[:, :-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SPECTRA)
def test_secular_kernel_matches_emulation_on_card(cuda_device, case, dtype):
    theta, c = _spectrum(case["m"], case["seed"], dtype,
                         case.get("shift", 0.0), case.get("zeros", 0))
    host = (theta, c, (1e-3 * 0.5 * 2.0 ** np.arange(6)).astype(dtype),
            np.asarray([0.1], dtype))
    args = [torch.from_numpy(v).to(cuda_device) for v in host]
    before = ts.eig_secular.launches
    lam, its = ts.eig_secular(*args, xtol=XTOL, it_max=IT_MAX)
    torch.cuda.synchronize()
    assert ts.eig_secular.launches == before + 1
    want = ts.eig_secular_emulated(*host, xtol=XTOL, it_max=IT_MAX)
    np.testing.assert_array_equal(lam.cpu().numpy(), want[0])
    np.testing.assert_array_equal(its.cpu().numpy(), want[1])
