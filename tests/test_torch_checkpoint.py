"""Checkpoint / resume of the port's solver runs
(krylov_crn_tpu_torch/utils/checkpoint.py): save, load and resume equals
an unbroken run, for CubicKrylov and for SSCN, whose coordinate generator
travels with the checkpoint."""

import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch import SSCN, CubicKrylov, LogisticRegression
from krylov_crn_tpu_torch.utils.checkpoint import (
    load_run,
    load_state,
    save_run,
    save_state,
)

CPU = "cpu"  # the library's default device is the card

SOLVERS = {
    "krylov": lambda loss: CubicKrylov(loss=loss, reg_coef=1e-3,
                                       subspace_dim=6, label="k"),
    "sscn": lambda loss: SSCN(loss=loss, reg_coef=1e-3, subspace_dim=10,
                              label="s"),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_save_load_run_resumes_exactly(tmp_path, small_problem, name):
    """12 iterations straight against 6, checkpoint, a fresh optimizer,
    6 more: the same state bit for bit (fp64)."""
    A, b, x0 = small_problem
    make = lambda: SOLVERS[name](LogisticRegression(A, b, dtype=np.float64, device=CPU))
    straight = make()
    straight.run(x0=x0, it_max=12)

    first = make()
    first.run(x0=x0, it_max=6)
    ck = tmp_path / "run.npz"
    save_run(ck, first)

    resumed = make()
    resumed.init_run(np.asarray(x0), 42)
    resumed.initialized = True
    load_run(ck, resumed)
    assert resumed.it == 6
    assert resumed.trace.its == first.trace.its
    resumed.run(x0=x0, it_max=12)
    for f in straight.state._fields:
        assert torch.equal(getattr(resumed.state, f),
                           getattr(straight.state, f)), f


def test_sscn_generator_state_is_what_resumes(tmp_path, small_problem):
    """Without the generator's state a resumed SSCN run draws other
    coordinates: the checkpoint is what makes the resume exact."""
    A, b, x0 = small_problem
    make = lambda: SOLVERS["sscn"](LogisticRegression(A, b,
                                                      dtype=np.float64, device=CPU))
    straight = make()
    straight.run(x0=x0, it_max=10)
    first = make()
    first.run(x0=x0, it_max=5)
    ck = tmp_path / "s.npz"
    save_state(ck, first.state, extra={"it": 5})
    fresh = make()
    fresh.init_run(np.asarray(x0), 42)
    fresh.initialized = True
    fresh.state, extra = load_state(ck, fresh.state)
    fresh.it = extra["it"]
    fresh.run(x0=x0, it_max=10)
    assert not torch.equal(fresh.state.x, straight.state.x)


def test_load_state_keeps_types_and_device(tmp_path, small_problem):
    A, b, x0 = small_problem
    alg = SOLVERS["krylov"](LogisticRegression(A, b, dtype=np.float32, device=CPU))
    alg.run(x0=x0, it_max=2)
    save_state(tmp_path / "st.npz", alg.state, extra={"note": "x"})
    st, extra = load_state(tmp_path / "st.npz", alg.state)
    assert type(st) is type(alg.state) and extra == {"note": "x"}
    for f in st._fields:
        a, b_ = getattr(st, f), getattr(alg.state, f)
        assert a.dtype == b_.dtype and a.device == b_.device
        assert torch.equal(a, b_)
