"""The port's d-space Lanczos (krylov_crn_tpu_torch/ops/lanczos.py)
against the JAX package's in fp64: alphas, betas, V, the stacked aux
(AV) and k, with and without reorthogonalization, and on a low-rank
operator where the Krylov space breaks down before m (masked tails and
the aux slot k - 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.ops.lanczos import lanczos as jlanczos
from krylov_crn_tpu_torch.ops.lanczos import lanczos


def _case(d, rank, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((rank, d)) / np.sqrt(d)  # op = B^T B, aux = B v
    g = rng.standard_normal(d)
    return B, g


@pytest.mark.parametrize("d, rank, m, reorth", [
    (60, 60, 12, 1),
    (60, 60, 12, 0),
    (60, 60, 8, 2),
    (80, 4, 12, 1),  # breaks down at k <= 5
    (50, 1, 6, 1),  # breaks down right after the first vector
])
def test_lanczos_matches_jax(d, rank, m, reorth):
    B, g = _case(d, rank, seed=d + rank + m)
    Bt = torch.from_numpy(B)
    Bj = jnp.asarray(B)
    got = lanczos(lambda v: (Bt.T @ (Bt @ v), Bt @ v), torch.from_numpy(g),
                  m, reorth_passes=reorth, accum_dtype=torch.float64)
    want = jlanczos(lambda v: (Bj.T @ (Bj @ v), Bj @ v), jnp.asarray(g), m,
                    reorth_passes=reorth, accum_dtype=jnp.float64)
    k = int(want.k)
    assert int(got.k) == k
    if rank < m:
        assert k <= rank + 1
        np.testing.assert_array_equal(got.V[k:].numpy(), 0)
        np.testing.assert_array_equal(got.alphas[k:].numpy(), 0)
        np.testing.assert_array_equal(got.betas[k - 1:].numpy(), 0)
    for name in ("alphas", "betas", "V", "aux"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                   err_msg=name)
    assert float(got.beta_last) == pytest.approx(float(want.beta_last),
                                                 rel=1e-10, abs=1e-14)
    # AV's rows stay matched to V's: row j is B v_j for every valid row
    np.testing.assert_allclose(got.aux[:k].numpy(), got.V[:k].numpy() @ B.T,
                               rtol=1e-10, atol=1e-12)


def test_zero_gradient_gives_zero_basis():
    d = 10
    H = torch.eye(d, dtype=torch.float64)
    res = lanczos(lambda v: (H @ v, None), torch.zeros(d, dtype=torch.float64),
                  4)
    assert not torch.isnan(res.V).any() and res.aux is None
    assert int(res.k) == 1
