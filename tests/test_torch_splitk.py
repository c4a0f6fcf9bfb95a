"""The split-K Gram build of the port (ops/gram.py: syrk_split_pieces,
syrk_split_P, _panel_accum, build_K_device) against the JAX package's
(_syrk_split_P, _panel_accum, _build_K_device) on the CPU.

On the CPU the split's product is its plain version: the same bf16
slices upcast to fp32 and multiplied in fp32. Every product of two
slices is exact in fp32, so the port and the JAX package sum the same
terms and differ only in the order of the fp32 sums. The tests marked
``cuda`` run the tensor-core product and skip without a card; the
machine with the card has no jax, so JAX is imported inside the tests
that need it.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch.config import pin_fp32_matmul_precision
from krylov_crn_tpu_torch.ops import gram as tg

CPU = torch.device("cpu")
U32 = 2.0 ** -24  # fp32 unit roundoff, round to nearest (the CPU's sums)


def _panel(seed, n, cb, spread=3.0):
    """An fp32 panel of normal-range values over ~2 * spread decades."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-spread, spread, (n, cb))
    return (rng.standard_normal((n, cb)) * mag).astype(np.float32)


def _jax():
    import jax
    import jax.numpy as jnp

    from krylov_crn_tpu.ops import gram as jg

    return jax, jnp, jg


def _bits(t):
    return t.float().numpy().view(np.uint32)


def _order_bound(B):
    """2 * 4cb * u * (|X| |Y|^T): how far two fp32 sums of the same 4cb
    exact terms, in any two orders, can lie apart."""
    X, Y = tg._split_operands(torch.from_numpy(B))
    S = X.abs().double() @ Y.abs().double().T
    return 2 * X.shape[1] * U32 * S.numpy()


@pytest.mark.parametrize("seed,shape", [(0, (64, 48)), (1, (300, 512)),
                                        (2, (17, 1000))])
def test_pieces_are_jax_reduce_precision_bit_for_bit(seed, shape):
    jax, jnp, jg = _jax()
    B = _panel(seed, *shape)
    b1, b2, b3 = tg.syrk_split_pieces(torch.from_numpy(B))
    assert b1.dtype == b2.dtype == b3.dtype == torch.bfloat16
    Bj = jnp.asarray(B)
    b1f = jax.lax.reduce_precision(Bj, 8, 7)
    r1 = Bj - b1f
    b2f = jax.lax.reduce_precision(r1, 8, 7)
    b3j = (r1 - b2f).astype(jnp.bfloat16).astype(jnp.float32)
    for got, want in ((b1, b1f), (b2, b2f), (b3, b3j)):
        np.testing.assert_array_equal(
            _bits(got), np.asarray(want, np.float32).view(np.uint32))
    # the slices hold B to ~2^-26 elementwise, and b1 alone does not
    s = b1.double() + b2.double() + b3.double()
    rel = ((s - torch.from_numpy(B).double()).abs()
           / torch.from_numpy(np.abs(B)).double()).max()
    assert rel <= 2.0 ** -24
    assert b2.abs().max() > 0 and b3.abs().max() > 0


def test_operands_are_the_jax_packages_stack():
    """X = [b1/2 | b2/2 | b1 | b1], Y = [b1 | b2 | b2 | b3], halving exact."""
    B = torch.from_numpy(_panel(3, 40, 16))
    b1, b2, b3 = tg.syrk_split_pieces(B)
    X, Y = tg._split_operands(B)
    assert X.shape == Y.shape == (40, 64) and X.dtype == torch.bfloat16
    wx = torch.cat([b1.float() * 0.5, b2.float() * 0.5, b1.float(),
                    b1.float()], 1)
    wy = torch.cat([b1, b2, b2, b3], 1).float()
    assert torch.equal(X.float(), wx) and torch.equal(Y.float(), wy)
    # into given buffers, as the build passes them
    X2, Y2 = torch.empty_like(X), torch.empty_like(Y)
    out = tg._split_operands(B, X2, Y2)
    assert out[0] is X2 and out[1] is Y2
    assert torch.equal(X2, X) and torch.equal(Y2, Y)


@pytest.mark.parametrize("seed,n,cb", [(4, 128, 96), (5, 300, 256)])
def test_plain_P_matches_jax_syrk_split_P(seed, n, cb):
    jax, jnp, jg = _jax()
    B = _panel(seed, n, cb, spread=1.0)
    got = tg.syrk_split_P_plain(torch.from_numpy(B)).numpy()
    want = np.asarray(jg._syrk_split_P(jnp.asarray(B)))
    assert got.dtype == want.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want) <= _order_bound(B))
    # a CPU tensor takes the plain version
    wrapped = tg.syrk_split_P(torch.from_numpy(B))
    assert torch.equal(wrapped, torch.from_numpy(got))


@pytest.mark.parametrize("seed", [7, 8])
def test_pair_sum_against_fp64(seed):
    """P + P^T is B B^T to fp32 accuracy (tests/test_gram.py:158-160's
    bound for the JAX package's _syrk_split) and bitwise symmetric."""
    B = np.random.default_rng(seed).standard_normal((128, 96)).astype(
        np.float32)
    P = tg.syrk_split_P(torch.from_numpy(B))
    S = P + P.T
    assert torch.equal(S, S.T)
    want = B.astype(np.float64) @ B.astype(np.float64).T
    rel = np.abs(S.numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-5, f"split rel err {rel:.3g} (one bf16 pass?)"
    # one bf16 pass alone is three orders coarser: the residuals count
    b1 = torch.from_numpy(B).to(torch.bfloat16).double()
    rel1 = (np.abs((b1 @ b1.T).numpy() - want).max() / np.abs(want).max())
    assert rel1 > 100 * rel


@pytest.mark.parametrize("dtype,split", [(np.float32, True),
                                         (np.float64, False)],
                         ids=["fp32", "fp64"])
def test_routing_fp32_takes_the_split(dtype, split, monkeypatch):
    """As the JAX package's _use_split: fp32 panels take the split (every
    device build is at HIGHEST there), fp64 the plain product. On the CPU
    the split's product is the plain one, and its card count stays 0."""
    jax, jnp, jg = _jax()
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert tg._use_split(tdt) is split
    assert jg._use_split(jnp.zeros((2, 2), dtype),
                         jax.lax.Precision.HIGHEST) is split
    B = torch.from_numpy(_panel(9, 64, 32, spread=1.0).astype(dtype))
    K = torch.zeros((64, 64), dtype=tdt)
    tg._panel_accum(K, B)
    if split:
        P = tg.syrk_split_P_plain(B)
        assert torch.equal(K, P + P.T)
    else:
        assert torch.equal(K, B @ B.T)
    A = sp.random(200, 1500, density=0.02, random_state=9, format="csr",
                  dtype=dtype)
    calls = []
    real = tg.syrk_split_P

    def counted(B, *bufs):
        calls.append(B.shape)
        return real(B, *bufs)

    monkeypatch.setattr(tg, "syrk_split_P", counted)
    tg.build_K_device.panels = real.cuda_calls = 0
    tg.build_K_device(A, 256, dtype, CPU, col_block=512)
    nblk = tg._pack_flat_panels(A, 256, np.dtype(dtype), 512)[-1]
    assert nblk == 3 and tg.build_K_device.panels == nblk
    assert calls == ([(256, 512)] * nblk if split else [])
    assert real.cuda_calls == 0


@pytest.fixture(scope="module")
def gram_problem():
    """tests/test_gram.py's fixture (n << d, the Gram regime)."""
    rng = np.random.default_rng(11)
    n, d = 300, 700
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    return sp.csr_matrix(Ad)


def test_fp32_build_matches_jax_build_and_host(gram_problem):
    """col_block=256 cuts the 700 active columns into three panels; the
    fp32 K is bitwise symmetric after the split's panels with no closing
    symmetrization, and within 1e-5 (tests/test_gram.py's bound) of the
    JAX package's split build and of host A A^T."""
    jax, jnp, jg = _jax()
    A = gram_problem
    n = A.shape[0]
    n_pad = tg.pad_rows(n)
    tg.build_K_device.panels = 0
    K = tg.build_K_device(A, n_pad, np.float32, CPU, col_block=256)
    assert tg.build_K_device.panels == 3
    assert K.dtype == torch.float32 and torch.equal(K, K.T)
    Kj = np.asarray(jg._build_K_device(A, n_pad, np.float32, col_block=256))
    host = np.zeros((n_pad, n_pad))
    host[:n, :n] = (A @ A.T).toarray()
    scale = np.abs(host).max()
    assert np.abs(K.numpy() - Kj).max() <= 1e-5 * scale
    assert np.abs(K.numpy() - host).max() <= 1e-5 * scale
    assert not K[n:].any() and not K[:, n:].any()


def test_build_default_col_block_is_the_jax_packages(gram_problem):
    """col_block defaults to 2048, as _build_K_device's: one panel here."""
    jax, jnp, jg = _jax()
    A = gram_problem
    tg.build_K_device.panels = 0
    tg.build_K_device(A, 512, np.float32, CPU)
    assert tg.build_K_device.panels == 1
    assert (tg._pack_flat_panels(A, 512, np.float32)[5]
            == jg._pack_flat_panels(A, 512, np.float32)[5] == 1024)


def test_fp32_race_on_the_split_K_reaches_the_fp64_optimum(small_problem):
    """The slice as a whole: the fp32 Gram race of the bench (m=10, chunk
    24, it_max 48, certify) on the split device build of the (400, 60)
    problem of test_fp32_path_reaches_fp64_optimum crosses a certified
    1e-8 gap against the JAX package's fp64 run and ends within that
    test's 1e-8 of it."""
    jax, jnp, jg = _jax()
    from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
    from krylov_crn_tpu.solvers import krylov_gram as jk
    from krylov_crn_tpu_torch import GramKrylov, LogisticRegression

    A, b, x0 = small_problem
    ja = jk.GramKrylov(loss=JLoss(A, b, dtype=np.float64), reg_coef=1e-3,
                       subspace_dim=10, tolerance=0, tqdm=False)
    st = ja.init_state(jnp.asarray(x0), 0)
    st, _ = jk.gram_krylov_multistep(
        ja.gd, st, chunk=40, accum_dtype=jnp.float64, l2=0.0, m=10,
        beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=20,
        reorth_passes=1)
    f64 = float(st.value) + float(st.value_lo)

    loss = LogisticRegression(A, b, dtype=np.float32, device=CPU)
    tg.build_K_device.panels = 0
    gd = tg.build_gram(A, loss.b[:A.shape[0]], x0, dtype=np.float32,
                       device=CPU, device_build=True)
    assert tg.build_K_device.panels == 1
    assert torch.equal(gd.K, gd.K.T)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=CPU, gram_data=gd)
    tr = alg.run_fused(x0, it_max=48, chunk=24, certify=True)
    assert alg.gd is gd and alg.state.zeta.dtype == torch.float32
    gaps = [f - f64 for f in tr.metrics["exact_fs"]]
    cross = next((it for it, g in zip(tr.metrics["exact_its"], gaps)
                  if g <= 1e-8), None)
    assert cross is not None and cross <= 48
    assert min(gaps) < 1e-8
    bfs = tr.metrics["boundary_fs"]
    assert all(b2 <= b1 for b1, b2 in zip(bfs, bfs[1:]))
    assert np.all(np.isfinite(np.asarray(tr.loss_vals)))


def test_pin_fp32_matmul_precision_turns_reduced_modes_off(monkeypatch):
    m = torch.backends.cuda.matmul
    for flag in ("allow_tf32", "allow_bf16_reduced_precision_reduction",
                 "allow_fp16_reduced_precision_reduction"):
        monkeypatch.setattr(m, flag, True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    pin_fp32_matmul_precision()
    assert m.allow_tf32 is False
    assert m.allow_bf16_reduced_precision_reduction is False
    assert m.allow_fp16_reduced_precision_reduction is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_measure_splitk_accuracy_on_the_cpu():
    """The tool's accuracy part, run on CPU tensors (its timings and the
    split's other contraction orders need a card): the split build and
    the direct fp32 product both within fp32 accuracy of the host fp64
    Gram."""
    from krylov_crn_tpu_torch.tools import measure_splitk

    A = sp.random(300, 3000, density=0.02, random_state=4, format="csr")
    out = measure_splitk._accuracy(A, CPU)
    assert set(out) == {"split", "sgemm_fp32"}
    for rec in out.values():
        assert 0 < rec["matvec_rel"] < 1e-6
        assert 0 < rec["elem_max_rel"] < 1e-5


@pytest.mark.parametrize("seed,shape", [(12, (256, 128)), (13, (96, 512))])
def test_split_vs_plain_control_exceeds_the_gate(seed, shape):
    """The comparison the card's P is held to has the power to refuse a
    bf16 output: on the CPU P is the plain version itself (share 0), and
    the plain P rounded to bf16 lies beyond ORDER_GATE of the any-order
    bound, which it would meet whole."""
    from krylov_crn_tpu_torch.tools import measure_splitk

    rng = np.random.default_rng(seed)
    B = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vp = measure_splitk.split_vs_plain(B)
    assert vp["max_abs_diff"] == vp["max_rel_to_order_bound"] == 0.0
    assert vp["bf16_out_rel_to_order_bound"] > vp["gate"] == 0.05


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the bf16 product has no CPU "
                    "mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_split_P_on_card_against_plain(cuda_device):
    """The tensor-core product against its plain version on the card:
    the same exact terms summed in another order, within ORDER_GATE of the
    any-order bound 2 * 4cb * 2^-23 * (|X| |Y|^T), and P rounded to bf16
    beyond it."""
    from krylov_crn_tpu_torch.tools import measure_splitk

    B = _panel(10, 2048, 512, spread=1.0)
    Bd = torch.from_numpy(B).to(cuda_device)
    tg.syrk_split_P.cuda_calls = 0
    P = tg.syrk_split_P(Bd)
    assert P.dtype == torch.float32 and P.is_cuda
    assert tg.syrk_split_P.cuda_calls == 1
    vp = measure_splitk.split_vs_plain(Bd)
    assert (vp["max_rel_to_order_bound"] <= vp["gate"]
            < vp["bf16_out_rel_to_order_bound"]), vp


@pytest.mark.cuda
def test_build_on_card_is_split_and_symmetric(cuda_device, gram_problem):
    A = gram_problem
    tg.build_K_device.panels = tg.syrk_split_P.cuda_calls = 0
    K = tg.build_K_device(A, 512, np.float32, cuda_device, col_block=256)
    assert tg.syrk_split_P.cuda_calls == tg.build_K_device.panels == 3
    assert torch.equal(K, K.T)
    want = (A @ A.T).toarray()
    err = np.abs(K.cpu().numpy()[:300, :300] - want).max()
    assert err <= 1e-5 * np.abs(want).max()
