"""The port's entry points default to the card: without one they raise and
name the remedy, and they run on the CPU only when asked to."""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_crn_tpu_torch import GramKrylov, LogisticRegression, convert
from krylov_crn_tpu_torch.config import resolve_device
from krylov_crn_tpu_torch.data.formats import (
    build_dual,
    from_scipy,
    padded_dense,
)
from krylov_crn_tpu_torch.graft_entry import entry
from krylov_crn_tpu_torch.ops.gram import build_gram
from krylov_crn_tpu_torch.parallel.launch import run_ranks
from krylov_crn_tpu_torch.parallel.mesh import make_mesh, single
from krylov_crn_tpu_torch.solvers.crn import CRNState


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    A = sp.random(40, 30, density=0.2, random_state=rng, format="csr")
    b = np.where(rng.random(40) < 0.5, -1.0, 1.0)
    return A, b, np.ones(30) * 0.5


def _gram_leaves(n_pad=256):
    z = np.zeros(n_pad)
    return types.SimpleNamespace(K=np.zeros((n_pad, n_pad)), Ax0=z, b=z,
                                 mask=z, x0_sqnorm=np.float64(1.0), n=40,
                                 d=30, nnz=7)


def _crn_leaves():
    return types.SimpleNamespace(**{f: np.zeros(3) for f in CRNState._fields})


def _rank_device(mesh):
    return str(mesh.device)


def _launch_one_rank(device=None):
    """One rank through the launcher; where it ran."""
    (dev,) = run_ranks(_rank_device, 1, None, device, 60.0)
    return types.SimpleNamespace(device=torch.device(dev))


ENTRY_POINTS = {
    "LogisticRegression": lambda p, **kw: LogisticRegression(p[0], p[1], **kw),
    "build_gram": lambda p, **kw: build_gram(*p, **kw),
    "from_scipy": lambda p, **kw: from_scipy(p[0], **kw),
    "padded_dense": lambda p, **kw: padded_dense(torch.ones(3, 5), **kw),
    "build_dual": lambda p, **kw: build_dual(p[0], **kw),
    "GramKrylov": lambda p, **kw: GramKrylov(
        loss=LogisticRegression(p[0], p[1], device="cpu"), reg_coef=1e-3,
        subspace_dim=4, **kw),
    "gram_data_from_numpy": lambda p, **kw: convert.gram_data_from_numpy(
        _gram_leaves(), **kw),
    "crn_state_from_numpy": lambda p, **kw: convert.crn_state_from_numpy(
        _crn_leaves(), **kw),
    "make_mesh": lambda p, **kw: make_mesh(**kw),
    "single_mesh": lambda p, **kw: single(**kw),
    "run_ranks": lambda p, **kw: _launch_one_rank(**kw),
    # the labels of the entry point's example arguments
    "graft_entry": lambda p, **kw: entry(**kw)[1][1],
}


def test_resolve_device_none_is_the_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_none_with_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(no_card, problem, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](problem)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(no_card, problem, name):
    got = ENTRY_POINTS[name](problem, device="cpu")
    dev = (got.K.device if name in ("build_gram", "gram_data_from_numpy")
           else got.x.device if name == "crn_state_from_numpy"
           else got.device)
    assert dev == torch.device("cpu")


def test_preset_gram_data_decides_the_device(no_card, problem):
    """A GramKrylov handed built Gram data runs where that data lies."""
    A, b, x0 = problem
    gd = build_gram(A, b, x0, dtype=np.float64, device="cpu")
    alg = GramKrylov(loss=LogisticRegression(A, b, dtype=np.float64,
                                             device="cpu"),
                     reg_coef=1e-3, subspace_dim=4, gram_data=gd)
    assert alg.device == torch.device("cpu")


def _terms_and_value(device, n=49_749, seed=5):
    """fp32 margins with terms of one sign and size, their fp32 terms
    summed in fp64, and the two-float value from the same margins."""
    from krylov_crn_tpu_torch.models.logistic import (
        logreg_value_from_margins,
        logsig,
    )

    rng = np.random.default_rng(seed)
    Ax = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    b = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)).to(device)
    terms = (1.0 - b) * Ax - logsig(Ax)
    hi, lo = logreg_value_from_margins(b, Ax, Ax[:3], n=n)
    return float(terms.double().mean()), float(hi) + float(lo)


def test_value_scales_terms_by_true_division():
    """The two-float value is the mean of its fp32 terms: dividing by n
    rounds each term once and the compensated sum adds nothing, so the
    value stays within 1e-9 of the terms' fp64 mean (n = 49,749, whose
    fp32 reciprocal is 2.2e-8 off: a product with it would show 1e-8)."""
    mean64, value = _terms_and_value("cpu")
    assert abs(value - mean64) <= 1e-9


@pytest.mark.cuda
def test_value_scales_terms_by_true_division_on_card():
    """The same on the card, where a tensor divided by a Python number
    becomes a product with the rounded reciprocal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    mean64, value = _terms_and_value(torch.device("cuda", 0))
    assert abs(value - mean64) <= 1e-9
