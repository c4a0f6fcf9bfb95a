"""Division by the row count n (krylov_crn_tpu_torch/ops/math.py).

The JAX package divides by n inside jit, where n is static (the sparse
matrices' shapes, ``GramData.n``), and XLA folds a division by a
compile-time constant into a product with the reciprocal rounded to the
operand's dtype, on every backend. Eager PyTorch divides truly on the CPU,
and on a card takes that product for a Python divisor (or a 0-d CPU
tensor), so the port's ``t / n`` gave two results. ``over_n`` takes the
JAX package's product in fp32 on every device (and divides truly in fp64,
as the host's exact values do); ``div_n`` divides truly on every device,
for the d-space value, whose reading is held against f*.

On the CPU: an fp32 ``over_n`` gives the bits of the JAX package's
jitted division, where true division differs, and the JAX package's gradient is
its A^T product times fl(1/n); ``div_n`` gives the bits of ``t / n`` and of
eager JAX. On the card (``cuda`` marker, skipped without one): both give
the CPU's bits, and the gradient, the HVP and the Gram scale vectors equal
their expressions times fl32(1/n) there and on the CPU, bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch import LogisticRegression
from krylov_crn_tpu_torch.ops.math import div_n, over_n, sigmoid
from krylov_crn_tpu_torch.ops.spmv import hvp_sparse, rmatvec, spmv

N_W8A = 49749  # w8a's rows: fl32(1/n) * n != 1


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)
            ).astype(np.float32)


def _recip(n, dtype=np.float32):
    return float(np.reciprocal(np.asarray(n, dtype=dtype)))


@pytest.mark.parametrize("n", [7, 300, N_W8A])
def test_over_n_is_the_jax_packages_division(n):
    """On the CPU an fp32 over_n gives the bits of the JAX package's t / n
    under jit with a static n, and true division does not. (jax is
    imported here: the card's machine has none.)"""
    import jax
    import jax.numpy as jnp

    t = _values(4096, n)
    got = over_n(torch.from_numpy(t), n).numpy()
    want = np.asarray(jax.jit(lambda r: r / n)(jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert not np.array_equal((torch.from_numpy(t) / n).numpy(), got)


@pytest.mark.parametrize("n", [7, 300, N_W8A])
def test_over_n_divides_fp64_truly(n):
    """An fp64 over_n is div_n: the true division of the host's exact
    fp64 values."""
    t = _values(4096, n).astype(np.float64)
    got = over_n(torch.from_numpy(t), n).numpy()
    np.testing.assert_array_equal(got, t / n)
    np.testing.assert_array_equal(got, div_n(torch.from_numpy(t), n).numpy())


@pytest.mark.parametrize("n", [7, 300, N_W8A])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_div_n_is_true_division_on_the_cpu(n, dtype):
    """On the CPU div_n, t / n and eager JAX's t / n agree bitwise."""
    import jax.numpy as jnp

    t = _values(4096, n).astype(dtype)
    got = div_n(torch.from_numpy(t), n).numpy()
    np.testing.assert_array_equal(got, (torch.from_numpy(t) / n).numpy())
    if dtype == np.float32:
        np.testing.assert_array_equal(got, np.asarray(jnp.asarray(t) / n))
    assert got.dtype == dtype


def _problem(n, d, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, d, density=0.05, random_state=seed, format="csr",
                  data_rvs=rng.standard_normal)
    b = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    return A, b, rng.standard_normal(d) * 0.1


def test_jax_package_gradient_takes_the_product():
    """The JAX package's fp32 gradient at n = 49,749 is its A^T product
    times fl32(1/n), not the product divided truly by n: the arithmetic
    the port's over_n reproduces."""
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.models import logistic as jlog
    from krylov_crn_tpu.ops.spmv import rmatvec as jrmatvec, spmv as jspmv

    A, b, x = _problem(N_W8A, 60, 3)
    jl = jlog.LogisticRegression(A, b, dtype=np.float32)
    xj = jnp.asarray(x.astype(np.float32))
    Ax = jax.jit(jspmv)(jl.data, xj)
    g = np.asarray(jlog.logreg_gradient_from_margins(jl.data, jl.b, Ax, xj))
    residual = jax.jit(lambda a: jlog.sigmoid(a) - jl.b)(Ax)
    r = np.asarray(jax.jit(jrmatvec)(jl.data, residual))
    np.testing.assert_array_equal(g, r * np.float32(_recip(N_W8A)))
    assert not np.array_equal(g, r / np.float32(N_W8A))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the two divisions differ there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_over_n_and_div_n_on_card_give_the_cpu_bits(cuda_device):
    t = torch.from_numpy(_values(1 << 16, 1))
    tc = t.to(cuda_device)
    assert torch.equal(over_n(tc, N_W8A).cpu(), over_n(t, N_W8A))
    # CUDA's own division by a Python number is the same product
    assert torch.equal((tc / N_W8A).cpu(), over_n(t, N_W8A))
    assert torch.equal(div_n(tc, N_W8A).cpu(), t / N_W8A)
    assert not torch.equal(over_n(t, N_W8A), t / N_W8A)


@pytest.mark.cuda
def test_gradient_and_hvp_take_the_product_on_card(cuda_device):
    """At n = 49,749 (the dense branch, through the matvec kernel): the
    gradient and the HVP are their A^T products times fl32(1/n), on the
    card and on the CPU, bit for bit."""
    A, b, x = _problem(N_W8A, 60, 3)
    loss = LogisticRegression(A, b, dtype=np.float32, device=cuda_device)
    data = loss.data
    inv = _recip(N_W8A)
    xt = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    g = loss.gradient(xt)
    Ax = spmv(data, xt)
    r = rmatvec(data, sigmoid(Ax) - loss.b_t)
    assert torch.equal(g, r * inv)
    assert torch.equal(g.cpu(), over_n(r.cpu(), N_W8A))
    w = sigmoid(Ax) * (1.0 - sigmoid(Ax))
    v = torch.ones_like(xt)
    h = hvp_sparse(data, w, v)
    q = rmatvec(data, w * spmv(data, v))
    assert torch.equal(h, q * inv)
    assert torch.equal(h.cpu(), over_n(q.cpu(), N_W8A))


@pytest.mark.cuda
def test_gram_scale_takes_the_product_on_card(cuda_device):
    """The Gram value's scale vector gd.mask / gd.n and the accept test's
    (1 - b) * mask / n on the card: the CPU's product with fl32(1/n)."""
    from krylov_crn_tpu_torch import GramKrylov

    A, b, x0 = _problem(601, 2000, 5)
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float32,
                                             device=cuda_device),
                     reg_coef=1e-3, subspace_dim=4, tolerance=0,
                     device=cuda_device)
    alg.init_state(x0, 42)
    gd = alg.gd
    inv = _recip(gd.n)
    assert torch.equal(over_n(gd.mask, gd.n), gd.mask * inv)
    p = (1.0 - gd.b) * gd.mask
    assert torch.equal(over_n(p, gd.n), p * inv)
    assert torch.equal(over_n(p, gd.n).cpu(), over_n(p.cpu(), gd.n))
