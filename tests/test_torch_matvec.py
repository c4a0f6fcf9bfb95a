"""The dense matvec kernel of the port (csrc/matvec.cu, ops/matvec.py).

On the CPU the kernel cannot run: these tests emulate its two-pass split
walk in PyTorch (with ``split_plan``, the rule the wrapper hands the
kernel), hold the emulation and the
plain version against fp64 in fp32 and bf16 at ragged shapes, and run the
TPU kernel it replaces (tools/measure_matvec.py:_matvec_kernel) in Pallas
interpret mode against the plain version on the same bits. The test
marked ``cuda`` runs the kernel itself and skips without a card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.ops.matvec import (
    UNROLL,
    matvec,
    matvec_plain,
    split_plan,
)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6  # relative to fp64: fp32 accumulation over rows of up to 20480


def _data(n, m, dtype, seed):
    rng = np.random.default_rng(seed)
    K = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    return K.to(dtype), x


def _rel(y, K, x):
    want = K.double() @ x.double()
    return float(torch.linalg.norm(y.double() - want)
                 / torch.linalg.norm(want))


def _lane_columns(c0, c1, lane, V):
    """Columns lane ``lane`` of a warp visits for a split [c0, c1), in
    its accumulation order (csrc/matvec.cu: matvec_rows)."""
    step = 32 * V
    out = []
    for base in range(c0, c1, step * UNROLL):
        for u in range(UNROLL):
            c = base + u * step + lane * V
            out.extend(range(c, min(c + V, c1)))
    return out


def _emulate(K, x):
    """The kernel's scheme in PyTorch (fp32): pass 1 gives one partial
    per (split, row) from 32 lane sums folded by the shuffle-down tree,
    pass 2 sums the splits in order. Also returns how often each column
    was visited."""
    n, m = K.shape
    V = 16 // K.element_size()
    splits, width = split_plan(n, m, K.element_size())
    Kf = K.float()
    seen = torch.zeros(m, dtype=torch.int64)
    W = torch.full((splits, n), float("nan"))
    for s in range(splits):
        c0, c1 = s * width, min(m, (s + 1) * width)
        acc = torch.zeros(n, 32)
        for lane in range(32):
            for c in _lane_columns(c0, c1, lane, V):
                acc[:, lane] = acc[:, lane] + Kf[:, c] * x[c]
                seen[c] += 1
        for off in (16, 8, 4, 2, 1):
            acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        W[s] = acc[:, 0]
    assert not torch.isnan(W).any(), "a workspace slot was never written"
    y = W[0].clone()
    for s in range(1, splits):
        y = y + W[s]
    return y, seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, m", [(7, 5), (61, 1000), (300, 4999),
                                  (1003, 333)])
def test_split_walk_emulation_matches_fp64(n, m, dtype):
    K, x = _data(n, m, dtype, seed=n + m)
    y, seen = _emulate(K, x)
    assert torch.equal(seen, torch.ones(m, dtype=torch.int64)), \
        "the split walk must visit every column exactly once"
    assert _rel(y, K, x) < TOL
    assert _rel(matvec_plain(K, x), K, x) < TOL
    np.testing.assert_allclose(y.numpy(), matvec_plain(K, x).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n, m, itemsize, splits", [
    (20480, 20480, 4, 1), (20480, 20480, 2, 1),  # the tool's shape
    (49749, 300, 4, 1), (49749, 300, 2, 1),  # w8a's A: many short rows
    (300, 49749, 4, 25), (300, 49749, 2, 25),  # w8a's A^T: few long rows
    (1003, 3333, 4, 7), (1, 1, 2, 1),
])
def test_split_plan(n, m, itemsize, splits):
    s, width = split_plan(n, m, itemsize)
    assert s == splits
    chunk = UNROLL * 32 * (16 // itemsize)
    assert width % chunk == 0 and (s - 1) * width < m <= s * width
    # A^T's few long rows still put thousands of warps on the card
    assert n * s >= min(n * -(-m // chunk), 7000)


def test_cpu_tensors_take_the_plain_version_uncounted():
    K, x = _data(40, 30, torch.float32, seed=1)
    before = matvec.launches
    assert torch.equal(matvec(K, x), matvec_plain(K, x))
    Kd, xd = K.double(), x.double()
    assert matvec(Kd, xd).dtype == torch.float64
    Kb = K.to(torch.bfloat16)
    assert torch.equal(matvec(Kb, x), Kb.float() @ x)
    assert matvec.launches == before


def _load_tool():
    """tools/measure_matvec.py, loaded from its path. Importing it turns
    on the JAX compilation cache; the previous settings are restored."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "measure_matvec_tool", ROOT / "tools" / "measure_matvec.py")
    tool = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(tool)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return tool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tpu_kernel_interpreted_matches_plain(dtype):
    """The Pallas kernel's own body, with the tool's BlockSpecs (bm = 512,
    bk = 2048), in interpret mode, against the port's plain version on
    the same bits. (jax is imported here: the card's machine has none.)"""
    import jax
    import jax.experimental.pallas as pl
    import jax.numpy as jnp

    tool = _load_tool()
    n, m, bm, bk = 1024, 4096, 512, 2048
    rng = np.random.default_rng(7)
    K32 = rng.standard_normal((n, m)).astype(np.float32)
    w = rng.standard_normal(m).astype(np.float32)
    Kj = jnp.asarray(K32).astype(getattr(jnp, dtype))
    out = pl.pallas_call(
        tool._matvec_kernel,
        grid=(n // bm, m // bk),
        in_specs=[pl.BlockSpec((bm, bk), lambda i, j: (i, j)),
                  pl.BlockSpec((1, bk), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((bm, 1), lambda i, j: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, 1), jnp.float32),
        interpret=True,
    )(Kj, jnp.asarray(w).reshape(1, m))
    y_tpu = np.asarray(out).reshape(n)
    Kt = torch.from_numpy(K32).to(getattr(torch, dtype))
    np.testing.assert_array_equal(Kt.float().numpy(),
                                  np.asarray(Kj.astype(jnp.float32)))
    y = matvec_plain(Kt, torch.from_numpy(w)).numpy().astype(np.float64)
    rel = np.linalg.norm(y - y_tpu) / np.linalg.norm(y_tpu)
    assert rel < TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, m", [(4096, 4096), (3000, 300), (300, 30000),
                                  (1003, 3333)])
def test_matvec_kernel_on_card(cuda_device, n, m, dtype):
    K, x = _data(n, m, dtype, seed=n * m)
    K, x = K.to(cuda_device), x.to(cuda_device)
    before = matvec.launches
    y = matvec(K, x)
    torch.cuda.synchronize()
    assert matvec.launches == before + 1
    assert _rel(y, K, x) < TOL
    assert torch.equal(y, matvec(K, x)), "kernel is not deterministic"
    # a padded view (vector loads) and an odd row stride (scalar loads)
    for ld in (m + (16 // K.element_size()), m + 1):
        buf = torch.zeros((n, ld), dtype=dtype, device=cuda_device)
        buf[:, :m] = K
        assert torch.equal(matvec(buf[:, :m], x), y)
    with pytest.raises(TypeError):
        matvec(K.double(), x.double())
    with pytest.raises(ValueError):
        matvec(K.T, torch.zeros(n, device=cuda_device))  # column stride
