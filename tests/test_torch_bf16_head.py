"""The bf16 Lanczos head of the port's Gram-space Krylov CRN against the
JAX package on the CPU: the bf16 copy of K, carrying it across, one head
step from a carried state, the switch between bf16 and fp32 K, and whole
fp32 runs with the head (``GramKrylov(bf16_head=True)``).

On the CPU the head's matvec is the matvec kernel's plain version on the
bf16 K and the bf16-rounded q (``_lr_matvec``): the same function as the
JAX package's ``dot_general`` of two bf16 operands with an fp32 result,
summed in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_crn_tpu.models.logistic import LogisticRegression as JLoss
from krylov_crn_tpu.ops import gram as jg
from krylov_crn_tpu.solvers import crn_gram as jcg
from krylov_crn_tpu.solvers import krylov_gram as jk
from krylov_crn_tpu_torch import GramCRN, GramKrylov, LogisticRegression
from krylov_crn_tpu_torch.convert import gram_data_from_numpy, state_from_numpy
from krylov_crn_tpu_torch.ops import gram as tg
from krylov_crn_tpu_torch.solvers import krylov_gram as tk

CPU = "cpu"  # the library's default device is the card

KW = dict(m=10, beta=0.5, solver_eps=1e-8, solver_it_max=100, ls_max=20,
          reorth_passes=1, l2=0.0, reg_ceil=1e6)
# one head step from the same fp32 state: both sides compute the same
# bf16 products, exact in fp32, and sum them in other orders. The Lanczos
# coefficients and basis then agree to fp32 rounding grown through m = 10
# Lanczos steps (measured: up to 1.0e-4 relative, Vw after two steps), and
# the images refreshed through the fp32 K to fp32 rounding of a product
# with cancellation (3.3e-5 against the fp64 product of the same basis)
LANCZOS_RTOL = 5e-4
IMAGE_RTOL = 1e-4
VALUE_RTOL = 1e-6  # the committed value (a two-float pair) of one step
# the committed zeta of one fp32 step is ill-conditioned: one step from
# the same state moves it by ~5e-6 relative between the packages with the
# head, and by up to ~1e-2 without it (fp32 alone)
ZETA_RTOL = 1e-3
# whole fp32 runs: the exact fp64 values of the iterates, where the two
# trajectories part at fp32 rounding and meet again at the fp32 floor
RUN_FINAL_ATOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _bf16_bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _jax_solver(A, b, head=True, cls=None, **kw):
    cls = cls or jk.GramKrylov
    return cls(loss=JLoss(A, b, dtype=np.float32), reg_coef=1e-3,
               subspace_dim=10, tolerance=0, tqdm=False, bf16_head=head, **kw)


def _port_solver(A, b, head=True, cls=None, **kw):
    cls = cls or GramKrylov
    return cls(loss=LogisticRegression(A, b, dtype=np.float32, device=CPU),
               reg_coef=1e-3, subspace_dim=10, tolerance=0, device=CPU,
               bf16_head=head, **kw)


def _watch_switch(alg):
    """Record ``alg.it`` where the head's switch to the fp32 K fires."""
    fired = []
    enter = alg._maybe_enter_fp32_tail

    def watched(grad_norm):
        before = alg._use_lr
        enter(grad_norm)
        if before and not alg._use_lr:
            fired.append(alg.it)

    alg._maybe_enter_fp32_tail = watched
    return fired


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_K_lr_is_the_jax_packages_bit_for_bit(small_problem, dtype):
    """fp32: K_lr is K rounded to bf16, the JAX package's bits; fp64 (and
    an explicit low_res_lanczos=False): no copy, as in the JAX package."""
    A, b, x0 = small_problem
    gj = jg.build_gram(A, b, x0, dtype=dtype, device_build=False)
    gt = tg.build_gram(A, b, x0, dtype=dtype, device=CPU)
    if dtype == np.float64:
        assert gj.K_lr is None and gt.K_lr is None
        assert gt.K_lanczos is gt.K
        return
    assert gt.K_lr.dtype == torch.bfloat16 and gt.K_lanczos is gt.K_lr
    np.testing.assert_array_equal(_bf16_bits(gt.K_lr), _bf16_bits(gj.K_lr))
    off = tg.build_gram(A, b, x0, dtype=dtype, device=CPU,
                        low_res_lanczos=False)
    assert off.K_lr is None and off.K_lanczos is off.K


def test_gram_data_from_numpy_carries_K_lr(small_problem):
    A, b, x0 = small_problem
    gj = jax.device_get(jg.build_gram(A, b, x0, dtype=np.float32,
                                      device_build=False))
    gt = gram_data_from_numpy(gj, device=CPU)
    assert gt.K_lr.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(gt.K_lr), _bf16_bits(gj.K_lr))
    gj64 = jax.device_get(jg.build_gram(A, b, x0, dtype=np.float64,
                                        device_build=False))
    assert gram_data_from_numpy(gj64, device=CPU).K_lr is None


def _capture_lanczos(monkeypatch, module):
    got = []
    lanczos = module.gram_lanczos

    def captured(*a, **kw):
        got.append(lanczos(*a, **kw))
        return got[-1]

    monkeypatch.setattr(module, "gram_lanczos", captured)
    return got


@pytest.mark.parametrize("after", [0, 2])
def test_one_head_step_matches_jax(small_problem, monkeypatch, after):
    """Both packages take one head step from the same fp32 state (carried
    by convert.py): the Lanczos coefficients and basis on the bf16 K, the
    images refreshed through the fp32 K, and the committed state."""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b)
    st = ja.init_state(jnp.asarray(x0), 0)
    for _ in range(after):
        st = jk.gram_krylov_step(ja.gd, st, accum_dtype=jnp.float32,
                                 use_lr=True, **KW)
    gd = gram_data_from_numpy(jax.device_get(ja.gd), device=CPU)
    st_t = state_from_numpy(jax.device_get(st), device=CPU)
    lz_j = _capture_lanczos(monkeypatch, jk)
    lz_t = _capture_lanczos(monkeypatch, tk)
    images = []
    refresh = tk._refresh_images
    monkeypatch.setattr(tk, "_refresh_images",
                        lambda *a: images.append(refresh(*a)) or images[-1])
    with jax.disable_jit():
        sj = jax.device_get(jk.gram_krylov_step(
            ja.gd, st, accum_dtype=jnp.float32, use_lr=True, **KW))
    s_t = tk.gram_krylov_step(gd, st_t, accum_dtype=torch.float32,
                              use_lr=True, **KW)
    lj, lt = jax.device_get(lz_j[0]), lz_t[0]
    for f in ("alphas", "betas", "Vb", "Vw"):
        assert _rel(getattr(lt, f).numpy(), getattr(lj, f)) < LANCZOS_RTOL, f
    # the refresh, Vb Ax0 + Vw K, of the port's basis and of the JAX
    # package's (in fp64): the images through the fp32 K to fp32 rounding,
    # and as close to the JAX package's as the bases are
    K64 = np.asarray(jax.device_get(ja.gd.K), np.float64)
    Ax0 = np.asarray(jax.device_get(ja.gd.Ax0), np.float64)

    def refreshed(lz):
        return (np.asarray(lz.Vb, np.float64)[:, None] * Ax0[None, :]
                + np.asarray(lz.Vw, np.float64) @ K64)

    assert len(images) == 1
    assert _rel(images[0].numpy(), refreshed(lt)) < IMAGE_RTOL
    assert _rel(images[0].numpy(), refreshed(lj)) < LANCZOS_RTOL
    # the bf16 images differ from the refreshed ones by bf16's rounding
    assert _rel(lt.Vu.numpy(), refreshed(lt)) > 100 * IMAGE_RTOL
    assert int(s_t.solver_it) == int(sj.solver_it)
    for f in ("gamma", "reg_coef", "r0", "grad_norm"):
        assert _rel(getattr(s_t, f).numpy(), getattr(sj, f)) < VALUE_RTOL, f
    got = float(s_t.value) + float(s_t.value_lo)
    assert abs(got - (float(sj.value) + float(sj.value_lo))) < (
        VALUE_RTOL * abs(got))
    assert _rel(s_t.zeta.numpy(), sj.zeta) < ZETA_RTOL


def test_use_lr_is_the_fp32_step_without_the_copy(small_problem):
    """use_lr=True on a GramData without K_lr, and use_lr=False on one
    with it, are the fp32 step bit for bit."""
    A, b, x0 = small_problem
    alg = _port_solver(A, b, head=True)
    st = alg.init_state(x0, 0)
    gd = alg.gd
    assert gd.K_lr is not None
    bare = dataclasses.replace(gd, K_lr=None)
    kw = dict(KW, accum_dtype=torch.float32)
    want = tk.gram_krylov_step(bare, st, use_lr=False, **kw)
    head = tk.gram_krylov_step(gd, st, use_lr=True, **kw)
    for got in (tk.gram_krylov_step(bare, st, use_lr=True, **kw),
                tk.gram_krylov_step(gd, st, use_lr=False, **kw)):
        for f in tk.GramKrylovState._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(head.zeta, want.zeta)


def test_run_fused_head_against_jax(small_problem):
    """A whole fp32 run with the head, run_fused(it_max=24, chunk=4,
    certify=True), in both packages: the switch to the fp32 K fires after
    the same chunk, every iterate is certified, the exact boundary values
    never rise, and both runs end at the same exact value.

    The iterations at which the runs roll back are not compared: both
    packages roll back only once their exact value has reached the fp32
    floor, and where that happens is decided by fp32 rounding (one step
    from the same state agrees to ~1e-7 in value, and the trajectories
    part). On this problem the JAX package rolls back after iteration 12
    and the port after 16 with the head; without it, after 16 and 8."""
    A, b, x0 = small_problem
    ja = _jax_solver(A, b)
    sw_j = _watch_switch(ja)
    tj = ja.run_fused(x0, it_max=24, chunk=4, certify=True)
    alg = _port_solver(A, b)
    sw_t = _watch_switch(alg)
    tt = alg.run_fused(x0, it_max=24, chunk=4, certify=True)
    assert alg.gd.K_lr.dtype == torch.bfloat16
    assert sw_t == sw_j and len(sw_t) == 1
    assert alg._gn_first == pytest.approx(ja._gn_first, rel=1e-6)
    assert not alg._use_lr and not ja._use_lr
    assert tt.metrics["exact_its"] == list(range(1, alg.it + 1))
    bfs = tt.metrics["boundary_fs"]
    assert all(b2 <= b1 for b1, b2 in zip(bfs, bfs[1:]))
    fj, ft = tj.metrics["exact_fs"], tt.metrics["exact_fs"]
    # the first chunk runs on the bf16 K from the same start
    np.testing.assert_allclose(ft[:2], fj[:2], rtol=VALUE_RTOL)
    assert abs(min(ft) - min(fj)) < RUN_FINAL_ATOL
    # each rollback comes after the run's exact value reached its floor
    for it in tt.metrics["rollback_its"]:
        assert tt.metrics["exact_fs"][it - 1] - min(ft) < RUN_FINAL_ATOL
    # and the head's run ends where the fp32 run without it ends
    t32 = _port_solver(A, b, head=False).run_fused(x0, it_max=24, chunk=4,
                                                   certify=True)
    assert abs(min(ft) - min(t32.metrics["exact_fs"])) < RUN_FINAL_ATOL


def test_run_head_switch_per_step_against_jax(small_problem):
    """Optimizer.run (one step per call, no exact corrections): each
    package tests the switch after every step and leaves the bf16 K after
    the first step whose gradient norm falls below fp32_tail_rtol times
    the first one. The first two steps agree to fp32 rounding.

    Past them the two trajectories part: the port run against itself with
    only the bf16 matvec's summation order changed (fp64 sums) moves the
    third step's value by 1.9e-6, as much as the JAX package's third step
    lies from the port's (1.1e-6). The gradient norm crosses the threshold
    (2.5e-4) at step 7 in the JAX package (1.6e-4 after 1.2e-3) and at
    step 8 in the port (1.7e-4 after 4.1e-4)."""
    A, b, x0 = small_problem
    runs = {}
    for name, alg in (("jax", _jax_solver(A, b)), ("port", _port_solver(A, b))):
        seen = []
        step = alg.step

        def watched(alg=alg, step=step, seen=seen):
            lr = alg._use_lr
            step()
            seen.append((float(alg.state.grad_norm),
                         float(alg.state.value) + float(alg.state.value_lo),
                         lr, alg._use_lr))

        alg.step = watched
        alg.run(x0, it_max=9)
        runs[name] = (alg, seen)
    for name, (alg, seen) in runs.items():
        first = seen[0][0]
        assert alg._gn_first == first
        # the switch fires once, after the first step below the threshold
        below = [g < alg.fp32_tail_rtol * first for g, _, _, _ in seen]
        k = below.index(True)
        assert [lr for _, _, lr, _ in seen] == [True] * (k + 1) + [False] * (
            len(seen) - k - 1), name
        assert not alg._use_lr
    (ja, sj), (alg, st) = runs["jax"], runs["port"]
    assert ja._gn_first == pytest.approx(alg._gn_first, rel=1e-6)
    for (gj, vj, _, _), (gt, vt, _, _) in zip(sj[:2], st[:2]):
        assert gt == pytest.approx(gj, rel=VALUE_RTOL)
        assert vt == pytest.approx(vj, rel=VALUE_RTOL)


def test_gram_crn_with_bf16_head_stays_fp32(gram_crn_problem):
    """GramCRN takes the head's arguments and builds the bf16 copy, but
    its step never reads it: three fp32 iterations bit for bit those of
    a GramCRN without the head, in the port and in the JAX package."""
    A, b, x0 = gram_crn_problem
    runs = {}
    for head in (False, True):
        alg = _port_solver(A, b, head=head, cls=GramCRN)
        alg.run(x0, it_max=3)
        assert (alg.gd.K_lr is not None) == head
        runs[head] = alg
        ja = _jax_solver(A, b, head=head, cls=jcg.GramCRN)
        ja.run(x0, it_max=3)
        assert (ja.gd.K_lr is not None) == head
    for f in ("gamma", "zeta", "value", "value_lo", "reg_coef"):
        assert torch.equal(getattr(runs[True].state, f),
                           getattr(runs[False].state, f)), f
    assert runs[True].trace.metrics["exact_fs"] == (
        runs[False].trace.metrics["exact_fs"])


@pytest.fixture(scope="module")
def gram_crn_problem():
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    n, d = 300, 700
    Ad = rng.standard_normal((n, d)) * (rng.random((n, d)) < 0.05)
    A = sp.csr_matrix(Ad)
    x_star = rng.standard_normal(d) / np.sqrt(d)
    b = np.where(Ad @ x_star + 0.4 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return A, b, np.ones(d) * 0.5
