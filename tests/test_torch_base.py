"""The port's run-loop options (krylov_crn_tpu_torch/solvers/base.py):
``store_iterates=False`` traces the state's loss values instead of the
iterates, and ``warm`` takes one throwaway step that leaves the next run
exactly as a fresh one."""

import numpy as np

from krylov_crn_tpu_torch import SSCN, GramCRN, LogisticRegression

CPU = "cpu"  # the library's default device is the card


def test_store_iterates_false_traces_state_values(small_problem):
    """The traced loss values are the state's two-float values: equal to
    the stored iterates' re-evaluated losses within rtol 1e-12 (fp64)."""
    A, b, x0 = small_problem
    traces = {}
    for store in (True, False):
        alg = SSCN(loss=LogisticRegression(A, b, dtype=np.float64, device=CPU),
                   reg_coef=1e-3, subspace_dim=10, store_iterates=store)
        tr = alg.run(x0=x0, it_max=8)
        if store:
            alg.compute_loss_of_iterates()
        traces[store] = tr
    kept, values = traces[True], traces[False]
    assert values.xs == [] and len(kept.xs) == len(kept.its)
    assert values.its == kept.its
    np.testing.assert_allclose(values.loss_vals, kept.loss_vals, rtol=1e-12)


def test_warm_leaves_the_next_run_fresh(small_problem):
    """GramCRN in fp32 writes exact-value metrics every step; after
    ``warm`` the run's trace and metrics equal a fresh run's exactly."""
    A, b, x0 = small_problem

    def make():
        return GramCRN(loss=LogisticRegression(A, b, dtype=np.float32, device=CPU),
                       reg_coef=1e-3, tolerance=0, device="cpu")

    fresh = make()
    fresh.run(x0=x0, it_max=3)
    warmed = make()
    warmed.warm(x0)
    assert not warmed.initialized
    assert warmed.trace.metrics.get("exact_fs", []) == []
    warmed.run(x0=x0, it_max=3)
    for key in ("exact_its", "exact_fs", "cg_its", "host_reads"):
        assert warmed.trace.metrics[key] == fresh.trace.metrics[key], key
    assert warmed.trace.its == fresh.trace.its
    assert float(warmed.state.value) == float(fresh.state.value)
