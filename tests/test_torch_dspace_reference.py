"""The port's d-space Krylov CRN held to the benchmark's plain fp64
reference of its step (``benchmark/reference_dspace.py``) on the CPU, at the
w8a-like configuration's CPU-test shape (1,200 x 300, clustered rows, the
dense branch): every step of a port run worked out again in fp64 from the
port's own iterate, and where it lands compared in loss. A sound fp64 run
lands where the reference does; a sound fp32 run stays under the limit of
the benchmark cell ``w8a.dspace_krylov``; a run with a planted fault does
not."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import datagen, reference_dspace
from krylov_crn_tpu_torch import CubicKrylov, LogisticRegression
from krylov_crn_tpu_torch.solvers import krylov_crn

CPU = "cpu"  # the library's default device is the card
REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "benchmark" / "configs" / "w8a-like.json"
LIMITS = REPO / "benchmark" / "limits" / "w8a.dspace_krylov.json"
REG, STEPS = 1e-3, 12


@pytest.fixture(scope="module")
def problem():
    cfg = datagen.tiny(json.loads(CONFIG.read_text()))
    A, b = datagen.make(cfg)
    return A, b, np.full(A.shape[1], 0.5)


def _run(problem, dtype, reorth_passes=1, solver_eps=1e-8, steps=STEPS):
    A, b, x0 = problem
    alg = CubicKrylov(loss=LogisticRegression(A, b, dtype=dtype, device=CPU),
                      reg_coef=REG, subspace_dim=10, solver_eps=solver_eps,
                      reorth_passes=reorth_passes, tolerance=0,
                      label="krylov")
    assert alg.loss.data.dense is not None  # the branch the cell runs
    trace = alg.run(x0, it_max=steps)
    assert trace.its == list(range(steps + 1))
    xs = [np.asarray(trace.xs[0], dtype)] + [x.numpy() for x in trace.xs[1:]]
    return np.stack(xs)


def _err(problem, xs, dtype, steps=None):
    A, b, _ = problem
    return reference_dspace.dspace_follow(
        A, b, xs, REG, ulp_eps=float(np.finfo(dtype).eps), steps=steps)


def _limit():
    return json.loads(LIMITS.read_text())["step_value_err"]


def test_an_fp64_run_lands_where_the_reference_does(problem):
    """Both sides in fp64, the port's secular Newton run to a step under
    1e-12 (the reference bisects to the last bit; at the traffic's 1e-8 a
    root at reg ~4e-6 stops far enough from it to move f by 2e-11 of f):
    what is left is the order of the sums, some ulps of f (2.6e-16 here),
    so 1e-12 of f holds with room."""
    steps = []
    xs = _run(problem, np.float64, solver_eps=1e-12)
    err = _err(problem, xs, np.float64, steps)
    assert err <= 1e-12, steps
    # the run moved: the first steps decrease f by far more than 1e-12
    assert steps[0]["f"] - steps[1]["f"] > 1e-3


def test_an_fp32_run_is_under_the_cells_limit(problem):
    """fp32 rounding of the iterate and of the step's sums moves f by ~1e-8
    of f at most (5e-8 at this shape, 1.5e-8 at the cell's, on the CPU);
    the cell's limit lies between that and the TF32 control's ~1e-5."""
    assert _err(problem, _run(problem, np.float32), np.float32) <= _limit()


def _shift_the_pick(monkeypatch):
    pick = krylov_crn._first_accepted

    def shifted(trials, state):
        idx = pick(trials, state)
        return torch.clamp(idx + 1, max=trials.regs.shape[0] - 1)

    monkeypatch.setattr(krylov_crn, "_first_accepted", shifted)
    return {}


def _no_reorthogonalization(monkeypatch):
    return {"reorth_passes": 0}


@pytest.mark.parametrize("plant", [_shift_the_pick, _no_reorthogonalization],
                         ids=["next_candidate_committed",
                              "lanczos_without_reorthogonalization"])
def test_a_planted_fault_reads_above_the_limit(problem, monkeypatch, plant):
    kw = plant(monkeypatch)
    xs = _run(problem, np.float32, **kw)
    assert _err(problem, xs, np.float32) > _limit()
