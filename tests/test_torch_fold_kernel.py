"""The fold kernel (csrc/fold.cu: ``sum2`` and ``dot2`` of a batch of
rows in one launch) on the card, held to its plain version
(``ops/math.py``: ``_lane_fold``, ``dot2_plain``) on the CPU bit for bit.
The CPU tests (tests/test_torch_math.py) hold the plain version to the
kernel's arithmetic emulated in numpy. Every test here is marked ``cuda``
and skips without a card; the file imports no jax, so that the card's
machine runs it (``--noconftest``)."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.ops import math as tm

SHAPES = [(1, 1), (3, 1023), (2, 20224), (2, 20480), (21, 20480),
          (21, 49749)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _operands(shape, dtype, seed, broadcast=False):
    rng = np.random.default_rng(seed)
    mags = lambda s: rng.standard_normal(s) * 10.0 ** rng.uniform(-5, 5, s)
    x = mags(shape[-1] if broadcast else shape).astype(dtype)
    return torch.from_numpy(x), torch.from_numpy(mags(shape).astype(dtype))


def _same_bits(got, want):
    """The same bits, NaN where the other is NaN (whatever its payload)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    u = {4: np.uint32, 8: np.uint64}[got.itemsize]
    np.testing.assert_array_equal(got[~nan].view(u), want[~nan].view(u))


def _special(dtype, kind):
    x, y = _operands((4, 3000), dtype, 17)
    x, y = x.numpy().copy(), y.numpy().copy()
    if kind == "signed_zero":
        x[:2] = -0.0
        x[2, :1024] = -0.0
        y[0], y[1] = -0.0, 0.0
    else:
        v = dtype(np.inf if kind == "inf" else np.nan)
        x[0, 5], x[1, 1500], y[2, 2999] = v, -v, v
        x[3, 7], x[3, 2048] = v, -v
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_is_its_plain_version(cuda_device, shape, dtype, broadcast):
    x, y = _operands(shape, dtype, sum(shape), broadcast)
    before = tm.fold.launches
    got_sum = tm.sum2(y.to(cuda_device))
    got_dot = tm.dot2(x.to(cuda_device), y.to(cuda_device))
    torch.cuda.synchronize()
    assert tm.fold.launches == before + 2
    for g, w in zip(got_sum + got_dot,
                    tm._lane_fold(y) + tm.dot2_plain(x, y)):
        _same_bits(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["inf", "nan", "signed_zero"])
def test_kernel_folds_special_values_as_its_plain_version(cuda_device,
                                                          kind, dtype):
    x, y = _special(dtype, kind)
    got = tm.sum2(x.to(cuda_device)) + tm.dot2(x.to(cuda_device),
                                               y.to(cuda_device))
    for g, w in zip(got, tm._lane_fold(x) + tm.dot2_plain(x, y)):
        _same_bits(g, w)


@pytest.mark.cuda
def test_cuda_inputs_never_take_the_plain_version(cuda_device, monkeypatch):
    """Every fold entry launches the kernel once a call for CUDA tensors
    (the accumulation dispatch, a strided and a 3-D batch included) and
    never reaches the plain version; what it does not take, it refuses."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA input took the plain fold")

    monkeypatch.setattr(tm, "_lane_fold", refuse)
    x, y = _operands((21, 20480), np.float32, 5)
    x, y = x.to(cuda_device), y.to(cuda_device)
    calls = [lambda: tm.sum2(y), lambda: tm.dot2(x, y),
             lambda: tm.accum_sum(y, torch.float32),
             lambda: tm.accum_dot(x, y, torch.float32),
             lambda: tm.accum_sum_pair(y, torch.float32),
             lambda: tm.dot2(y[:, ::2], y[:, 1::2]),
             lambda: tm.sum2(y.reshape(3, 7, 20480))]
    for call in calls:
        before = tm.fold.launches
        call()
        assert tm.fold.launches == before + 1
    torch.cuda.synchronize()
    hi, lo = tm.sum2(y.reshape(3, 7, 20480))
    assert hi.shape == lo.shape == (3, 7)
    with pytest.raises(TypeError):
        tm.sum2(y.half())
    with pytest.raises(TypeError):
        tm.dot2(x, y.double())
    with pytest.raises(ValueError):
        tm.dot2(x, y[:, :-1])
    with pytest.raises(ValueError):
        tm.dot2(x, y.cpu())
