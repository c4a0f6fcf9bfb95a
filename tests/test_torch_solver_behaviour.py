"""Run-loop behaviour that the JAX package's suite tests and the port's
other tests never reach, each on ``small_problem`` against the JAX
package's run on the CPU: trace thinning (tests/test_solvers.py
test_trace_subsampling), seed restart (test_seed_restart_resumes), a
whole CubicNewton run stopping on its gradient tolerance
(tests/test_early_exit.py test_crn_run_terminates_on_grad_tolerance), a
60-iteration Gram multistep at a zero gradient
(test_zero_gradient_step_is_nan_free) and ``Trace.plot_distances``
(tests/test_plotting.py)."""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from krylov_crn_tpu import CubicKrylov as JKrylov  # noqa: E402
from krylov_crn_tpu import CubicNewton as JNewton  # noqa: E402
from krylov_crn_tpu.models.logistic import (  # noqa: E402
    LogisticRegression as JLoss,
)
from krylov_crn_tpu.solvers import krylov_gram as jk  # noqa: E402
from krylov_crn_tpu_torch import (  # noqa: E402
    CubicKrylov,
    CubicNewton,
    GramKrylov,
    LogisticRegression,
)
from krylov_crn_tpu_torch.solvers import krylov_gram as tk  # noqa: E402

CPU = "cpu"  # the library's default device is the card


def _losses(A, b):
    return (JLoss(A, b, dtype=np.float64),
            LogisticRegression(A, b, dtype=np.float64, device=CPU))


def test_trace_subsampling_matches_jax(small_problem):
    """The first save_first_iterations + 1 checkpoints are kept, then the
    trace thins by progress: the same iterations as the JAX package's."""
    A, b, x0 = small_problem
    jl, tl = _losses(A, b)
    kw = dict(reg_coef=1e-3, subspace_dim=5, trace_len=12,
              save_first_iterations=3, label="k")
    tj = JKrylov(loss=jl, tqdm=False, **kw).run(x0=x0, it_max=30)
    tt = CubicKrylov(loss=tl, **kw).run(x0=x0, it_max=30)
    assert tt.its[:4] == [0, 1, 2, 3]
    assert len(tt.its) <= 12 + 4
    assert list(tt.its) == list(tj.its)
    assert len(tt.xs) == len(tt.its)


def test_seed_restart_resumes_as_jax(small_problem):
    """Two seeds run in turn; a second run of the same optimizer finds
    both finished and returns the same trace without stepping."""
    A, b, x0 = small_problem
    jl, tl = _losses(A, b)
    kw = dict(reg_coef=1e-3, subspace_dim=5, seeds=[1, 2], label="k")
    ja = JKrylov(loss=jl, tqdm=False, **kw)
    alg = CubicKrylov(loss=tl, **kw)
    tj, tt = ja.run(x0=x0, it_max=5), alg.run(x0=x0, it_max=5)
    assert alg.finished_seeds == ja.finished_seeds == [1, 2]
    its, value = list(tt.its), float(alg.state.value)
    assert its == list(tj.its)
    assert value == pytest.approx(float(ja.state.value), rel=1e-10)
    assert alg.run(x0=x0, it_max=5) is tt
    assert list(tt.its) == its and float(alg.state.value) == value


def test_crn_run_stops_on_grad_tolerance_as_jax(small_problem):
    """CubicNewton("full") with tolerance 1e-2 stops long before its cap,
    at the JAX package's iteration, with the same value."""
    A, b, x0 = small_problem
    jl, tl = _losses(A, b)
    kw = dict(reg_coef=1e-3, cubic_solver="full", tolerance=1e-2,
              label="crn")
    ja = JNewton(loss=jl, tqdm=False, **kw)
    ja.run(x0=x0, it_max=200)
    alg = CubicNewton(loss=tl, **kw)
    alg.run(x0=x0, it_max=200)
    assert alg.it == ja.it < 200
    assert (float(alg.state.grad_norm) < 1e-2
            or float(alg.state.diff_norm) < 1e-2)
    assert float(alg.state.value) == pytest.approx(float(ja.state.value),
                                                   rel=1e-12)


def test_zero_gradient_gram_multistep_stays_finite(small_problem):
    """60 Gram Krylov iterations on a 60-dimensional problem, far past
    exact convergence, where the gradient is numerically zero: the
    Lanczos normalization guards 0/0 and ties are accepted, so nothing
    becomes NaN, and the value is the JAX package's."""
    A, b, x0 = small_problem
    kw = dict(m=10, l2=0.0, beta=0.5, solver_eps=1e-8, solver_it_max=100,
              ls_max=20, reorth_passes=1)
    jl, tl = _losses(A, b)
    ja = jk.GramKrylov(loss=jl, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                       tqdm=False)
    sj = ja.init_state(jnp.asarray(x0), 42)
    sj, outs_j = jk.gram_krylov_multistep(ja.gd, sj, chunk=60,
                                          accum_dtype=jnp.float64, **kw)
    alg = GramKrylov(loss=tl, reg_coef=1e-3, subspace_dim=10, tolerance=0,
                     device=CPU)
    st = alg.init_state(x0, 42)
    st, outs = tk.gram_krylov_multistep(alg.gd, st, chunk=60,
                                        accum_dtype=torch.float64, **kw)
    for f in ("value", "reg_coef", "gamma"):
        assert np.isfinite(float(getattr(st, f))), f
    assert torch.isfinite(st.zeta).all()
    assert torch.isfinite(outs[0][0]).all()
    # past convergence the gradient norm reads noise, below 1e-6 of its
    # start (the JAX package alternates 2.7e-9 and 1.6e-7 here)
    for gns in (np.asarray(outs_j[1]), outs[1].numpy()):
        assert np.all(gns[-20:] < 1e-6 * gns[0])
    # the committed value pairs drift apart through the noise steps; the
    # iterates themselves, evaluated exactly on the host, agree
    A64 = A.tocsr()
    b01 = (np.asarray(b) > 0).astype(np.float64)
    Ax0 = A64 @ x0
    exact = [tk._exact_value(A64, Ax0, b01, float(s.gamma),
                             np.asarray(s.zeta, np.float64)[:A.shape[0]],
                             0.0, x0)[0]
             for s in (sj, st)]
    assert exact[1] == pytest.approx(exact[0], abs=1e-15)


@pytest.mark.parametrize("gram", [False, True])
def test_plot_distances_matches_jax(small_problem, tmp_path, gram):
    """Trace.plot_distances on the Agg backend: the squared distances to
    x* the port draws are the JAX package's (d-space iterates, and Gram
    checkpoints materialized from their reps)."""
    A, b, x0 = small_problem
    jl, tl = _losses(A, b)
    if gram:
        ja = jk.GramKrylov(loss=jl, reg_coef=1e-3, subspace_dim=6,
                           tqdm=False, label="gram")
        alg = GramKrylov(loss=tl, reg_coef=1e-3, subspace_dim=6,
                         label="gram", device=CPU)
    else:
        ja = JKrylov(loss=jl, reg_coef=1e-3, subspace_dim=6, tqdm=False,
                     label="k")
        alg = CubicKrylov(loss=tl, reg_coef=1e-3, subspace_dim=6, label="k")
    traces = []
    for opt in (ja, alg):
        traces.append(opt.run(x0=x0, it_max=8))
        opt.compute_loss_of_iterates()
    # both drawn against the JAX package's x* (each oracle's own x_opt is
    # its own best iterate, which the other run passes at a distance of
    # its rounding)
    x_opt = np.asarray(jl.x_opt)
    lines = []
    for trace in traces:
        plt.figure()
        trace.plot_distances(x_opt=x_opt)
        lines.append(plt.gca().lines[0].get_xydata())
        plt.savefig(tmp_path / f"dists_{len(lines)}.pdf")
        plt.close("all")
        assert (tmp_path / f"dists_{len(lines)}.pdf").stat().st_size > 0
    want, got = lines
    assert got.shape == want.shape and got.shape[0] > 2
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-8,
                               atol=1e-14)
    assert got[-1, 1] < got[0, 1]
