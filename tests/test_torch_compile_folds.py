"""The two-float layer (krylov_crn_tpu_torch/ops/math.py) under
``torch.compile`` on the CPU, with inductor's C++ backend: which of the
error-free transforms and folds keep their eager bits.

Measured with torch 2.13 on the CPU: ``two_sum``, ``_split``,
``_two_prod``, ``sum2`` and ``dot2_plain`` give the eager bits, and
``two_sum`` stays error-free. ``dot2`` keeps its hi; its lo adds a plain
sum of the product errors, which inductor reordered while that sum was a
``torch.sum`` (they are now added into lo row by row, as ``csrc/fold.cu``
adds them). So the module's warning holds: compiled, the
layer is the eager layer bit for bit only where the order is written out,
and on a card a compiler that contracts a * b + c into an FMA would break
the transforms themselves. The solvers never compile it."""

import os
import shutil

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.ops import math as tm

SHAPE = (2, 3000)  # a batch of two rows, not a multiple of the 1024 lanes


@pytest.fixture(scope="module")
def operands():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("inductor's CPU backend needs a C++ compiler")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(SHAPE, generator=g) * torch.exp(
        4 * torch.randn(SHAPE, generator=g))
    y = torch.randn(SHAPE, generator=g)
    return x, y


def _compiled(fn, *args):
    torch._dynamo.reset()
    out = torch.compile(fn, backend="inductor", fullgraph=True)(*args)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", ["two_sum", "_split", "_two_prod", "sum2",
                                  "dot2_plain"])
def test_compiled_transform_keeps_eager_bits(operands, name):
    x, y = operands
    fn = getattr(tm, name)
    args = (x,) if name in ("_split", "sum2") else (x, y)
    eager = fn(*args)
    for got, want in zip(_compiled(fn, *args), eager):
        assert torch.equal(got, want), name
    if name == "two_sum":
        # still error-free: s + e is a + b exactly
        s, e = (t.double() for t in _compiled(fn, x, y))
        assert torch.equal(s + e, x.double() + y.double())


def test_compiled_dot2_keeps_hi_and_reorders_lo(operands):
    """dot2's hi is the compensated fold's, bit for bit; its lo adds a
    plain sum of the product errors, which a compiled version may sum in
    another order: it stays within that sum's rounding, and the pair
    stays as close to the exact dot as the eager pair."""
    x, y = operands
    hi_e, lo_e = tm.dot2(x, y)
    hi_c, lo_c = _compiled(tm.dot2, x, y)
    assert torch.equal(hi_c, hi_e)
    _, err = tm._two_prod(x, y)
    eps = float(np.finfo(np.float32).eps)
    bound = SHAPE[1] * eps * err.abs().sum(-1).double()
    assert torch.all((lo_c.double() - lo_e.double()).abs() <= bound)
    exact = (x.double() * y.double()).sum(-1)
    scale = (x.double() * y.double()).abs().sum(-1)
    for hi, lo in ((hi_e, lo_e), (hi_c, lo_c)):
        assert torch.all((hi.double() + lo.double() - exact).abs()
                         <= 4 * eps * eps * scale + bound)
