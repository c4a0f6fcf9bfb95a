"""The dense matvec kernel of the port (csrc/matvec.cu, ops/matvec.py).

On the CPU the kernel cannot run: these tests emulate its walk in
PyTorch (with ``split_plan``, the plan the wrapper hands the kernel: row
tiles and column chunks, each block's run of units, the lanes of a row,
the shuffle tree, the block-ordered sum of shared tiles), hold the
emulation and the plain version against fp64 in fp32 and bf16 at ragged
shapes, and run the
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
    BLOCKS_PER_SM,
    GRID,
    SMS,
    THREADS,
    matvec,
    matvec_plain,
    smem_bytes,
    split_plan,
    unit_start,
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


def _cdiv(a, b):
    return -(-a // b)


def _lane_vectors(tcv, lpr, lane):
    """The 16-byte vectors of a row chunk that lane ``lane`` of the row's
    ``lpr`` lanes reads, in its accumulation order (csrc/matvec.cu:
    matvec_stream)."""
    return list(range(lane, tcv, lpr))


def _emulate(K, x):
    """The kernel's walk in PyTorch (fp32): each block of the plan takes
    its run of (row tile, column chunk) units in order; lane g of a row
    accumulates the elements of its vectors (``_lane_vectors``) over the
    tile's chunks that the block holds; the shuffle-down tree folds the
    lanes; a tile wholly inside a block writes y, a shared one leaves a
    partial in the block's first or last slot, and the shared tiles'
    partials are summed in block order. Also returns how often each
    column was visited for each row tile."""
    n, m = K.shape
    V = 16 // K.element_size()
    p = split_plan(n, m, K.element_size())
    tiles = _cdiv(n, p.tr)
    width = p.ct * p.tcv * V
    Kp = torch.zeros(tiles * p.tr, width)
    Kp[:n, :m] = K.float()
    xp = torch.zeros(width)
    xp[:m] = x
    seen = torch.zeros(width, dtype=torch.int64)
    y = torch.full((n,), float("nan"))
    W = torch.full((p.grid, 2, p.tr), float("nan"))
    lanes = torch.arange(p.lpr)
    for b in range(p.grid):
        u0 = unit_start(b, p.units, p.grid)
        u1 = unit_start(b + 1, p.units, p.grid)
        assert u1 > u0, "a block without work"
        acc = torch.zeros(p.tr, p.lpr)
        for u in range(u0, u1):
            t, c = divmod(u, p.ct)
            rows = Kp[t * p.tr:(t + 1) * p.tr]
            for k in range(_cdiv(p.tcv, p.lpr)):
                js = lanes + k * p.lpr
                live = js < p.tcv
                for i in range(V):
                    cols = (c * p.tcv + js[live]) * V + i
                    acc[:, live] = acc[:, live] + rows[:, cols] * xp[cols]
                    seen[cols] += 1
            if c == p.ct - 1 or u == u1 - 1:
                off = p.lpr // 2
                while off:
                    acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
                    off //= 2
                r0, r1 = t * p.tr, min(n, (t + 1) * p.tr)
                if t * p.ct >= u0 and (t + 1) * p.ct <= u1:
                    y[r0:r1] = acc[:r1 - r0, 0]
                else:
                    W[b, 0 if t == u0 // p.ct else 1, :r1 - r0] = \
                        acc[:r1 - r0, 0]
                acc = torch.zeros(p.tr, p.lpr)
    if p.combine:
        for t in range(tiles):
            owners = [b for b in range(p.grid)
                      if unit_start(b, p.units, p.grid) < (t + 1) * p.ct
                      and unit_start(b + 1, p.units, p.grid) > t * p.ct]
            if len(owners) < 2:
                continue
            r0, r1 = t * p.tr, min(n, (t + 1) * p.tr)
            s = None
            for b in owners:
                slot = 0 if unit_start(b, p.units, p.grid) // p.ct == t else 1
                part = W[b, slot, :r1 - r0]
                s = part.clone() if s is None else s + part
            y[r0:r1] = s
    assert not torch.isnan(y).any(), "a row was never written"
    return y, seen[:m] // tiles, seen[m:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, m", [(7, 5), (61, 1000), (300, 4999),
                                  (1003, 333)])
def test_split_walk_emulation_matches_fp64(n, m, dtype):
    K, x = _data(n, m, dtype, seed=n + m)
    y, seen, beyond = _emulate(K, x)
    assert torch.equal(seen, torch.ones(m, dtype=torch.int64)), \
        "the walk must visit every column of every row tile exactly once"
    assert torch.all(beyond <= _cdiv(n, split_plan(n, m, K.element_size()).tr))
    assert _rel(y, K, x) < TOL
    assert _rel(matvec_plain(K, x), K, x) < TOL
    np.testing.assert_allclose(y.numpy(), matvec_plain(K, x).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n, m, itemsize, plan", [
    # (lanes per row, column chunks, grid, combine)
    (20480, 20480, 4, (32, 40, GRID, True)),  # the tool's shape
    (20480, 20480, 2, (32, 20, GRID, True)),
    (49749, 300, 4, (16, 1, SMS, False)),  # w8a's A: many short rows
    (49749, 300, 2, (8, 1, SMS, False)),
    (300, 49749, 4, (32, 49, SMS, True)),  # w8a's A^T: few long rows
    (300, 49749, 2, (32, 25, SMS, True)),
    (1003, 3333, 4, (32, 4, SMS, True)), (1, 1, 2, (1, 1, 1, False)),
])
def test_split_plan(n, m, itemsize, plan):
    p = split_plan(n, m, itemsize)
    assert (p.lpr, p.ct, p.grid, p.combine) == plan
    V = 16 // itemsize
    assert p.tr * p.lpr == THREADS and 32 % p.lpr == 0
    assert (p.ct - 1) * p.tcv * V < m <= p.ct * p.tcv * V
    assert p.units == _cdiv(n, p.tr) * p.ct and 1 <= p.grid <= p.units
    # every block's run is the same number of units, give or take one
    runs = {unit_start(b + 1, p.units, p.grid) - unit_start(b, p.units, p.grid)
            for b in range(p.grid)}
    assert max(runs) - min(runs) <= 1
    # the ring (STAGES slots of a tile and, chunked, its x) and the staged
    # x fit as many times as the grid puts blocks on an SM (at most
    # BLOCKS_PER_SM) in an SM's 227 KB of shared memory
    per_sm = _cdiv(p.grid, SMS)
    assert per_sm <= BLOCKS_PER_SM
    assert per_sm * smem_bytes(p, itemsize) <= 232448


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
                                  (1003, 3333), (5120, 20480), (49749, 300),
                                  (300, 49749), (8, 300000)])
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
