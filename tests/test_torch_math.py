"""Two-float layer of the port (krylov_crn_tpu_torch/ops/math.py) against
exact arithmetic and against the JAX package's fp32 results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.ops import math as jm
from krylov_crn_tpu_torch.ops import math as tm


def _f32(rng, n, scale=1.0, shift=0.0):
    return (rng.standard_normal(n) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_sum_is_error_free(seed):
    rng = np.random.default_rng(seed)
    a = _f32(rng, 4096, 1e3)
    b = _f32(rng, 4096, 1e-5)
    s, e = tm.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    # fp32 sums are exact in fp64
    want = a.astype(np.float64) + b.astype(np.float64)
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_prod_is_error_free(seed):
    rng = np.random.default_rng(seed)
    a = _f32(rng, 4096, 10.0)
    b = _f32(rng, 4096, 0.1)
    p, e = tm._two_prod(torch.from_numpy(a), torch.from_numpy(b))
    # a 24 x 24-bit product is exact in fp64's 53 bits
    want = a.astype(np.float64) * b.astype(np.float64)
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)


def test_two_sum_fp64_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(999) * 1e8, rng.standard_normal(999)
    s, e = tm.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    sj, ej = jm.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))


@pytest.mark.parametrize("n", [100, 1024, 19996, 20480])
def test_sum2_matches_jax_fp32(n):
    rng = np.random.default_rng(n)
    x = _f32(rng, n, 0.7, 0.69)
    hi, lo = tm.sum2(torch.from_numpy(x))
    hj, lj = jax.jit(jm.sum2)(jnp.asarray(x))
    got = float(hi) + float(lo)
    want = float(hj) + float(lj)
    assert abs(got - want) <= 1e-12 * abs(want)
    true = np.sum(x.astype(np.float64))
    assert abs(got - true) < 1e-9 * abs(true)


@pytest.mark.parametrize("n", [100, 12345, 20480])
def test_dot2_matches_jax_fp32(n):
    rng = np.random.default_rng(n + 1)
    x, y = _f32(rng, n), _f32(rng, n)
    hi, lo = tm.dot2(torch.from_numpy(x), torch.from_numpy(y))
    hj, lj = jax.jit(jm.dot2)(jnp.asarray(x), jnp.asarray(y))
    got = float(hi) + float(lo)
    want = float(hj) + float(lj)
    scale = float(np.dot(np.abs(x), np.abs(y)))
    assert abs(got - want) <= 1e-12 * scale
    true = np.dot(x.astype(np.float64), y.astype(np.float64))
    assert abs(got - true) < 1e-9 * scale


def test_batched_fold_equals_rowwise():
    """The leading batch axis (the 21 line-search candidates) folds each
    row exactly as a lone 1-D fold would."""
    rng = np.random.default_rng(9)
    X = torch.from_numpy(rng.standard_normal((21, 3000)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    hb, lb = tm.dot2(y, X)
    for r in range(21):
        h, lo = tm.dot2(y, X[r])
        assert torch.equal(h, hb[r]) and torch.equal(lo, lb[r])


# the shapes the folds meet: one value; a row short of the lanes; rep_dot's
# two rows at news20-like's and rcv1-like's n_pad; the Gram step's 21
# candidates; the d-space step's 21 candidates at w8a's n
FOLD_SHAPES = [(1, 1), (3, 1023), (2, 20224), (2, 20480), (21, 20480),
               (21, 49749)]
FOLD_DTYPES = [np.float32, np.float64]


def _operands(shape, dtype, seed, broadcast=False):
    """Values of mixed signs over ten decades; with ``broadcast`` x is one
    row that every row of y meets, as ``_candidate_df``'s (n,) weights."""
    rng = np.random.default_rng(seed)
    mags = lambda s: rng.standard_normal(s) * 10.0 ** rng.uniform(-5, 5, s)
    x = mags(shape[-1] if broadcast else shape).astype(dtype)
    y = mags(shape).astype(dtype)
    return x, y


@np.errstate(invalid="ignore", over="ignore")
def _fold_emulated(x, y=None, lanes=tm.LANES, terms=False):
    """csrc/fold.cu's arithmetic in numpy, one thread a lane (the lanes a
    vector axis), each operation rounded in the operands' dtype: the row
    pass with reads past n as +0, then the halving tree; for dot2 each
    row's product errors added into lo after its two_sum errors, the
    first row's as lo's start. With ``terms`` also the sum of |t| over
    every term that went into lo (fp64)."""
    x = np.asarray(x)
    dt = x.dtype.type
    n = x.shape[-1]
    if y is not None:
        x, y = np.broadcast_arrays(x, np.asarray(y))
    rows = max(-(-n // lanes), 1)
    split = dt(134217729.0 if dt is np.float64 else 4097.0)

    def row(a, r):
        out = np.zeros(a.shape[:-1] + (lanes,), dt)
        seg = a[..., r * lanes:(r + 1) * lanes]
        out[..., :seg.shape[-1]] = seg
        return out

    def two_sum(a, b):
        s = a + b
        bb = s - a
        return s, (a - (s - bb)) + (b - bb)

    def halves(a):
        c = split * a
        h = c - (c - a)
        return h, a - h

    hi = lo = None
    mag = 0.0
    for r in range(rows):
        v, e = row(x, r), np.zeros(x.shape[:-1] + (lanes,), dt)
        if y is not None:
            a, b = v, row(y, r)
            v = a * b
            (ah, al), (bh, bl) = halves(a), halves(b)
            e = ((ah * bh - v) + ah * bl + al * bh) + al * bl
            past = np.arange(r * lanes, (r + 1) * lanes) >= n
            v[..., past] = 0
            e[..., past] = 0
        mag = mag + np.abs(e.astype(np.float64)).sum(-1)
        if r == 0:
            hi, lo = v, e
        else:
            hi, err = two_sum(hi, v)
            lo = lo + err
            if y is not None:
                lo = lo + e
            mag = mag + np.abs(err.astype(np.float64)).sum(-1)
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        hi, err = two_sum(hi[..., :h], hi[..., h:])
        lo = (lo[..., :h] + lo[..., h:]) + err
        mag = mag + np.abs(err.astype(np.float64)).sum(-1)
    if terms:
        return hi[..., 0], lo[..., 0], mag
    return hi[..., 0], lo[..., 0]


def _same_bits(got, want):
    """The same bits, NaN where the other is NaN (whatever its payload)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    u = {4: np.uint32, 8: np.uint64}[got.itemsize]
    np.testing.assert_array_equal(got[~nan].view(u), want[~nan].view(u))


def _dot2_before(x, y):
    """dot2 before the kernel: the product errors summed by torch.sum
    apart from the two_sum errors."""
    p, e = tm._two_prod(x, y)
    hi, lo = tm._lane_fold(p)
    return hi, lo + e.sum(-1)


@pytest.mark.parametrize("dtype", FOLD_DTYPES)
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_sum2_is_the_kernels_fold(shape, dtype):
    """sum2 on the CPU (``_lane_fold``) folds as csrc/fold.cu does, bit
    for bit, at every shape the folds meet."""
    x, _ = _operands(shape, dtype, sum(shape))
    hi, lo = tm.sum2(torch.from_numpy(x))
    want = _fold_emulated(x)
    _same_bits(hi.numpy(), want[0])
    _same_bits(lo.numpy(), want[1])


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", FOLD_DTYPES)
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_dot2_plain_is_the_kernels_fold(shape, dtype, broadcast):
    """dot2_plain folds as csrc/fold.cu does, bit for bit, a broadcast
    1-D operand included; it is the CPU's dot2."""
    x, y = _operands(shape, dtype, sum(shape) + 1, broadcast)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    hi, lo = tm.dot2_plain(tx, ty)
    want = _fold_emulated(x, y)
    _same_bits(hi.numpy(), want[0])
    _same_bits(lo.numpy(), want[1])
    for got, w in zip(tm.dot2(tx, ty), (hi, lo)):
        assert torch.equal(got, w)


@pytest.mark.parametrize("dtype", FOLD_DTYPES)
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_dot2_plain_keeps_hi_and_bounds_lo(shape, dtype):
    """Against dot2 before the kernel: hi bit for bit; lo moves only by
    the reordered plain sum of its terms (the two_sum and product errors),
    within the two orders' rounding bound: N eps sum |t| over the N terms
    (with the few percent of gamma_N's denominator)."""
    x, y = _operands(shape, dtype, sum(shape) + 2, broadcast=True)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    hi_b, lo_b = _dot2_before(tx, ty)
    hi, lo = tm.dot2_plain(tx, ty)
    assert torch.equal(hi, hi_b)
    *_, mag = _fold_emulated(x, y, terms=True)
    eps = float(np.finfo(dtype).eps)
    n_terms = 2 * max(-(-shape[-1] // tm.LANES), 1) * tm.LANES
    bound = 1.01 * n_terms * eps * torch.from_numpy(np.asarray(mag))
    assert torch.all((lo.double() - lo_b.double()).abs() <= bound)


@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_dot2_matches_fp64_dot(shape):
    """The fp32 pair against fp64 ``np.dot`` (fp32 products are exact in
    fp64) within 1e-9 of the scale sum |x y|."""
    x, y = _operands(shape, np.float32, sum(shape) + 3, broadcast=True)
    hi, lo = tm.dot2(torch.from_numpy(x), torch.from_numpy(y))
    got = hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = np.array([np.dot(x64, r) for r in y64])
    scale = np.abs(y64) @ np.abs(x64)
    assert np.all(np.abs(got - want) <= 1e-9 * scale)


@pytest.mark.parametrize("dtype", FOLD_DTYPES)
@pytest.mark.parametrize("special", ["inf", "nan", "signed_zero"])
def test_folds_of_special_values_are_the_kernels(special, dtype):
    """inf, NaN and signed zeros fold as csrc/fold.cu folds them: rows of
    -0 (whose padded lanes are +0), one inf or NaN among finite values,
    inf - inf."""
    n = 3000
    x, y = _operands((4, n), dtype, 17)
    if special == "signed_zero":
        x[:2] = -0.0
        x[2, :1024] = -0.0
        y[0] = -0.0
        y[1] = 0.0
    else:
        v = dtype(np.inf if special == "inf" else np.nan)
        x[0, 5], x[1, 1500], y[2, 2999] = v, -v, v
        x[3, 7], x[3, 2048] = v, -v
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in zip(tm.sum2(tx), _fold_emulated(x)):
        _same_bits(got.numpy(), want)
    for got, want in zip(tm.dot2_plain(tx, ty), _fold_emulated(x, y)):
        _same_bits(got.numpy(), want)


def test_pair_diff_resolves_tiny_gaps():
    a64 = 0.6931471805599453
    b64 = a64 + 3.7e-9
    ah, bh = np.float32(a64), np.float32(b64)
    al, bl = np.float32(a64 - np.float64(ah)), np.float32(b64 - np.float64(bh))
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    d = float(tm.pair_diff(t(bh), t(bl), t(ah), t(al)))
    dj = float(jm.pair_diff(jnp.float32(bh), jnp.float32(bl),
                            jnp.float32(ah), jnp.float32(al)))
    assert abs(d - 3.7e-9) < 1e-15
    assert d == dj
    nan = tm.pair_diff(t(np.nan), t(0.0), t(1.0), t(0.0))
    assert bool(torch.isnan(nan)) and not bool(nan <= 0)


def test_accum_dispatch_and_clamps():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1000)
    x32 = torch.from_numpy(x.astype(np.float32))
    hi, lo = tm.accum_sum_pair(x32, torch.float64)
    assert float(lo) == 0.0
    assert abs(float(hi) - np.sum(x.astype(np.float32).astype(np.float64))) \
        < 1e-12
    hi, lo = tm.accum_sum_pair(x32, torch.float32)
    assert hi.dtype == torch.float32 and float(lo) != 0.0
    assert float(tm.reg_clamp(torch.tensor(5e7), 1e6)) == 1e6
    ok = tm.ls_accept(torch.tensor(1.0), torch.tensor(0.0),
                      torch.tensor(1.0), torch.tensor(0.0),
                      torch.tensor(0.0))
    assert bool(ok)


def test_logsig_and_softplus_match_jax_fp64():
    x = np.linspace(-60.0, 60.0, 2001)
    np.testing.assert_allclose(tm.logsig(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)),
                               rtol=1e-15, atol=1e-300)
    # F.softplus would return x above 20; the port's is exact
    np.testing.assert_allclose(tm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-15)
