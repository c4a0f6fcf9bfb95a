"""Gram data, K builds and Gram-space Lanczos of the port against the JAX
package, in fp64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu.ops import gram as jg
from krylov_crn_tpu_torch.convert import gram_data_from_numpy
from krylov_crn_tpu_torch.ops import gram as tg

CPU = "cpu"  # the library's default device is the card


@pytest.fixture(scope="module")
def gram_problem():
    rng = np.random.default_rng(11)
    n, d = 300, 700  # wide: n << d, the Gram regime
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    b = np.where(rng.random(n) < 0.5, 0.0, 1.0)
    return sp.csr_matrix(Ad), b, np.ones(d) * 0.5


@pytest.fixture(scope="module")
def both_gd(gram_problem):
    A, b, x0 = gram_problem
    gj = jg.build_gram(A, b, x0, dtype=np.float64, low_res_lanczos=False)
    gt = tg.build_gram(A, b, x0, dtype=np.float64, device=CPU)
    return gj, gt


def test_cpu_build_equals_jax_build(both_gd):
    gj, gt = both_gd
    assert gt.n_padded == gj.n_padded == 512
    np.testing.assert_array_equal(gt.K.numpy(), np.asarray(gj.K))
    for f in ("Ax0", "b", "mask", "x0_sqnorm"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert (gt.n, gt.d, gt.nnz) == (gj.n, gj.d, gj.nnz)


def test_device_build_matches_jax_build(gram_problem, both_gd):
    A, b, x0 = gram_problem
    gj, _ = both_gd
    gd = tg.build_gram(A, b, x0, dtype=np.float64, device_build=True,
                       device=CPU)
    np.testing.assert_allclose(gd.K.numpy(), np.asarray(gj.K), rtol=1e-12,
                               atol=1e-12)
    assert torch.equal(gd.K, gd.K.T)


def test_heavy_skew_build_raises():
    """Heavy column skew builds and matches the host (the name dates from
    when the port raised on it): where the JAX package leaves its panel
    scan (its ``_pack_flat_panels`` returns None), the port's one build
    path gives host A A^T (tests/test_torch_gram_skew.py holds it against
    the JAX fallback)."""
    rng = np.random.default_rng(0)
    A = sp.random(64, 9000, density=0.0005, random_state=rng, format="csr")
    assert jg._pack_flat_panels(A, 256, np.float64) is None
    packed = tg._pack_flat_panels(A, 256, np.float64)
    assert tg._heavy_skew(packed[4], A.nnz)
    gd = tg.build_gram(A, np.ones(64), np.ones(9000), dtype=np.float64,
                       device_build=True, device=CPU)
    np.testing.assert_allclose(gd.K.numpy()[:64, :64], (A @ A.T).toarray(),
                               rtol=0, atol=1e-12)


def test_rep_dot_matches_jax(both_gd):
    gj, gt = both_gd
    rng = np.random.default_rng(1)
    npad = gt.n_padded
    w1, w2 = rng.standard_normal((2, npad)) * gt.mask.numpy()
    K = gt.K.numpy()
    reps = []
    for beta, w in ((0.7, w1), (-1.3, w2)):
        u = beta * gt.Ax0.numpy() + K @ w
        reps.append((beta, w, u))
    rt = [tg.Rep(torch.tensor(bt, dtype=torch.float64), torch.from_numpy(w), torch.from_numpy(u))
          for bt, w, u in reps]
    rj = [jg.Rep(jnp.asarray(bt), jnp.asarray(w), jnp.asarray(u))
          for bt, w, u in reps]
    got = float(tg.rep_dot(gt, rt[0], rt[1], torch.float64))
    want = float(jg.rep_dot(gj, rj[0], rj[1], jnp.float64))
    assert abs(got - want) <= 1e-13 * max(1.0, abs(want))


@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_gram_lanczos_matches_jax(both_gd, l2):
    gj, gt = both_gd
    m = 8
    rng = np.random.default_rng(2)
    npad = gt.n_padded
    mask = gt.mask.numpy()
    D = rng.random(npad) * 0.25 * mask / gt.n
    w = rng.standard_normal(npad) * mask
    beta = 0.3
    u = beta * gt.Ax0.numpy() + gt.K.numpy() @ w

    def hop_j(v):
        q = jnp.asarray(D) * v.u
        return jg.Rep(l2 * v.beta, q + l2 * v.w, gj.K @ q + l2 * v.u)

    def hop_t(v):
        q = torch.from_numpy(D) * v.u
        return tg.Rep(l2 * v.beta, q + l2 * v.w,
                      tg.k_matvec(gt.K, q) + l2 * v.u)

    lj = jax.jit(lambda g: jg.gram_lanczos(gj, hop_j, g, m,
                                           accum_dtype=jnp.float64))(
        jg.Rep(jnp.asarray(beta), jnp.asarray(w), jnp.asarray(u)))
    lt = tg.gram_lanczos(gt, hop_t, tg.Rep(torch.tensor(beta, dtype=torch.float64),
                                           torch.from_numpy(w),
                                           torch.from_numpy(u)), m,
                         accum_dtype=torch.float64)
    assert int(lt.k) == int(lj.k) == m
    for f in ("alphas", "betas", "Vb", "Vw", "Vu"):
        a, bb = getattr(lt, f).numpy(), np.asarray(getattr(lj, f))
        err = np.abs(a - bb).max() / np.abs(bb).max()
        assert err < 1e-10, f"{f}: rel err {err:.3g}"


def test_gram_data_from_numpy_carries_jax_data(both_gd):
    gj, gt = both_gd
    gc = gram_data_from_numpy(jax.device_get(gj), device=CPU)
    for f in ("K", "Ax0", "b", "mask", "x0_sqnorm"):
        assert torch.equal(getattr(gc, f), getattr(gt, f)), f
    assert (gc.n, gc.d, gc.nnz) == (gt.n, gt.d, gt.nnz)


def test_k_matvec_counts_only_card_calls(both_gd):
    _, gt = both_gd
    before = tg.k_matvec.cuda_calls
    q = torch.ones(gt.n_padded, dtype=torch.float64)
    torch.testing.assert_close(tg.k_matvec(gt.K, q), gt.K @ q)
    assert tg.k_matvec.cuda_calls == before
