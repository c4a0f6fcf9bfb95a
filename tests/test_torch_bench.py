"""The port's bench (krylov_crn_tpu_torch/bench.py) against bench.py.

bench.py is imported as the reference and not edited. On the CPU: the
scoring of ``race`` on the stubbed attempts of tests/test_bench_scoring.py
(both races give the same output, key by key), the problem and the
crossing helpers, ``bench_ours`` against the same calls through the JAX
package's GramKrylov on a small problem, ``main``'s JSON with its parts
stubbed alike, and the refusal to run without a card. The timed functions
run on the card only (``cuda`` marker)."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import bench
from krylov_crn_tpu_torch import bench as tb

CPU = "cpu"
# (300, 20) with 1,500 drawn entries: both packages' m=10 races cross a
# certified 1e-8 gap at iteration 25, right after the exact correction at
# the first chunk boundary; the (400, 60) shapes do not cross in 48
SMALL = (300, 20, 1500)
FSTAR_IT = 96  # both sides alike, to keep the JAX run short
# both f_best are exact fp64 values of fp32 iterates at the fp32 floor
# (certified gaps there ~4e-12), reached along trajectories whose fp32
# rounding differs: 4.2e-10 relative apart (7.6e-11 absolute on f* = 0.18)
F_BEST_RTOL = 1e-9
ADDED_KEYS = {"ours_crossing_it", "symv_launches", "graph_replays", "k_build"}

# tests/test_bench_scoring.py's cases: ours as (build_s, ts, fs, f_best),
# the reference as (ts, fs, f_best), and the crossing iteration of ours'
# scored attempt (ts[i] belongs to iteration i + 1)
SCORING = {
    "min_over_crossing_attempts": (
        [(1.0, [2.0], [1e-9], 1e-10), (0.4, [0.5], [1e-9], 1e-10)],
        [([1.0, 3.0], [1e-4, 1e-9], 1e-10),
         ([1.0, 3.5], [1e-4, 1e-9], 1e-10)], 1),
    "reference_never_crossing": (
        [(0.5, [1.0], [1e-9], 1e-10), (0.5, [1.0], [1e-9], 1e-10)],
        [([6.0, 12.0], [1e-3, 1e-4], 1e-10),
         ([7.0, 14.0], [1e-3, 1e-4], 1e-10)], 1),
    "mixed_reference_attempts": (
        [(0.5, [1.0], [1e-9], 1e-10), (0.5, [1.0], [1e-9], 1e-10)],
        [([5.0], [1e-4], 1e-10), ([4.0, 9.0], [1e-4, 1e-9], 1e-10)], 1),
    "ours_not_crossing": (
        [(0.5, [1.0], [1e-7], 1e-10), (0.5, [1.0], [1e-7], 1e-10)],
        [([1.0, 3.0], [1e-4, 1e-9], 1e-10),
         ([1.0, 3.0], [1e-4, 1e-9], 1e-10)], None),
}


@pytest.mark.parametrize("case", sorted(SCORING))
def test_race_scoring_equals_bench(monkeypatch, case):
    ours, ref, crossing_it = SCORING[case]
    monkeypatch.setattr(bench, "_problem", lambda name: (None, None, None))
    monkeypatch.setattr(tb, "_problem", lambda name: (None, None, None))
    meta = lambda name: {"dataset": name}  # noqa: E731
    monkeypatch.setattr("krylov_crn_tpu.data.synthetic.synthetic_meta", meta)
    monkeypatch.setattr(tb, "synthetic_meta", meta)
    jit, jref = iter(ours), iter(ref)
    monkeypatch.setattr(bench, "bench_ours", lambda A, b, x0: next(jit))
    monkeypatch.setattr(bench, "bench_reference",
                        lambda A, b, x0: next(jref))
    pit, pref = iter(ours), iter(ref)
    monkeypatch.setattr(
        tb, "bench_ours", lambda A, b, x0, device=None: tb.Attempt(
            *next(pit), its=(1,), race_s=10.0))
    monkeypatch.setattr(tb, "bench_reference", lambda A, b, x0: next(pref))

    want = bench.race("x")
    got = tb.race("x", device=CPU)
    assert set(got) == set(want) | ADDED_KEYS
    for key, value in want.items():
        assert got[key] == value, key
    assert got["ours_crossing_it"] == crossing_it
    # no K-matvec ran: no launch, and none on the card; no K was built
    assert got["symv_launches"] == {"launches": 0, "k_matvec_calls": 0}
    assert got["k_build"] == {"panels": 0, "split_panels": 0}


def test_problem_is_bench_problem():
    A, b, x0 = tb._problem((400, 60, 2000))
    Aj, bj, x0j = bench._problem((400, 60, 2000))
    assert A.shape == Aj.shape == (400, 60)
    for part in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(A, part), getattr(Aj, part)), part
    assert A.dtype == Aj.dtype
    assert np.array_equal(b, bj) and np.array_equal(x0, x0j)


CROSSINGS = {
    "empty": ([], [], 1e-8),
    "first": ([0.5, 1.0], [1e-9, 1e-10], 1e-8),
    "equal_to_target": ([0.5, 1.0, 2.0], [1e-4, 1e-8, 1e-10], 1e-8),
    "never": ([0.5, 1.0], [1e-4, 2e-8], 1e-8),
    "numpy_times": (np.array([0.25, 0.75], np.float32),
                    np.array([1e-3, -1e-12]), 1e-8),
}


@pytest.mark.parametrize("case", sorted(CROSSINGS))
def test_crossing_equals_bench(case):
    ts, gaps, target = CROSSINGS[case]
    got, want = tb._crossing(ts, gaps, target), bench._crossing(ts, gaps,
                                                                target)
    assert got == want
    assert got is None or type(got) is float


def _jax_bench_ours(A, b, x0):
    """bench.py's ``bench_ours`` calls through the JAX package's
    GramKrylov, without its relay warm-ups and compilation cache."""
    import jax.numpy as jnp

    from krylov_crn_tpu.models.logistic import LogisticRegression
    from krylov_crn_tpu.solvers.krylov_gram import GramKrylov

    loss = LogisticRegression(A, b, dtype=np.float32, want_dense=False)
    alg = GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=bench.M,
                     tolerance=0, tqdm=False, label="gram")
    alg.init_run(jnp.asarray(x0, np.float32), 42)
    alg.initialized = True
    trace = alg.run_fused(x0, it_max=bench.OUR_IT_MAX, chunk=bench.CHUNK,
                          certify=True)
    its = list(trace.metrics["exact_its"])
    fs = [float(v) for v in trace.metrics["exact_fs"]]
    GramKrylov(loss=loss, reg_coef=1e-3, subspace_dim=2 * bench.M,
               tolerance=0, tqdm=False, label="gram-bench",
               gram_data=alg.gd).run_fused(x0, it_max=FSTAR_IT, chunk=32)
    return its, fs, float(loss.f_opt)


def test_bench_ours_crosses_where_the_jax_package_does(monkeypatch):
    monkeypatch.setattr(tb, "FSTAR_IT", FSTAR_IT)
    A, b, x0 = tb._problem(SMALL)
    got = tb.bench_ours(A, b, x0, device=CPU)
    its, fs, f_best = _jax_bench_ours(A, b, x0)

    assert tuple(got.its) == tuple(its) == tuple(range(1, 49))
    assert len(got.ts) == len(got.fs) == len(got.its)
    assert got.build_s >= 0 and np.all(np.diff(got.ts) >= 0)
    assert 0 < got.ts[-1] <= got.race_s
    assert got.f_best == pytest.approx(f_best, rel=F_BEST_RTOL, abs=0)
    f_star = min(got.f_best, f_best)

    def crossing_it(its, fs):
        return next(i for i, f in zip(its, fs) if f - f_star <= bench.GAP)

    assert crossing_it(got.its, got.fs) == crossing_it(its, fs) == 25


def test_main_json_has_every_bench_key(monkeypatch, capsys):
    def fake_race(name, reps=2, **kw):
        return {"ours_s": len(name) + 0.5, "speedup": None, "reps": reps}

    parts = {"race": fake_race,
             "kmatvec_roofline": lambda **kw: (1900.5, 0.567, 0.321, 5226.0),
             "coo_hvp_nnz_per_s": lambda **kw: 812.4}
    for name, fn in parts.items():
        monkeypatch.setattr(bench, name, fn)
        monkeypatch.setattr(tb, name, fn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("krylov_crn_tpu_torch.utils.profiling."
                        "card_description",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tb.main(["--reps", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == set(want) | {"card", "hvp_format"}
    for key, value in want.items():
        if key in ("news20", "rcv1"):
            assert got[key] == dict(value, reps=3)
        else:
            assert got[key] == value, key
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got["hvp_format"] == "csr"


ENTRIES = {
    "main": lambda: tb.main([]),
    "race": lambda: tb.race("rcv1-like"),
    "bench_ours": lambda: tb.bench_ours(None, None, None),
    "kmatvec_roofline": lambda: tb.kmatvec_roofline(n=64),
    "coo_hvp_nnz_per_s": lambda: tb.coo_hvp_nnz_per_s(SMALL),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*a, **kw):
        raise AssertionError("ran without a card")

    for name in ("_problem", "synthetic_logreg"):
        monkeypatch.setattr(tb, name, ran)
    with pytest.raises(RuntimeError, match="is_available"):
        ENTRIES[entry]()


def test_timing_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="needs a card"):
        tb.kmatvec_roofline(n=64, device=CPU)


def test_bench_reference_without_upstream_code(monkeypatch, tmp_path):
    monkeypatch.setattr(tb, "REFERENCE_DIR", tmp_path / "reference")
    # keep the stub bench_reference puts in place from outliving the test
    monkeypatch.setitem(sys.modules, "numba", types.ModuleType("numba"))
    path = list(sys.path)
    assert tb.bench_reference(None, None, None) is None
    assert sys.path == path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (timing and the SYMV kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bench_ours_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(tb, "FSTAR_IT", FSTAR_IT)
    from krylov_crn_tpu_torch.ops.symv import symv

    A, b, x0 = tb._problem(SMALL)
    before = symv.launches
    got = tb.bench_ours(A, b, x0, device=cuda_device)
    assert symv.launches > before
    assert got.ts[-1] <= got.race_s and np.all(np.isfinite(got.fs))


@pytest.mark.cuda
def test_race_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(tb, "FSTAR_IT", FSTAR_IT)
    out = tb.race(SMALL, reps=2, device=cuda_device)
    launches = out["symv_launches"]
    assert launches["launches"] == launches["k_matvec_calls"] > 0
    assert out["k_build"]["split_panels"] == out["k_build"]["panels"] == 2
    assert out["ours_gap_reached"] and out["ours_crossing_it"] <= 48
    assert len(out["ours_attempts_s"]) == 2


@pytest.mark.cuda
def test_kmatvec_roofline_on_card(cuda_device):
    gbps, frac, symv_ms, eff = tb.kmatvec_roofline(n=4096,
                                                   device=cuda_device)
    assert gbps > 0 and 0 < frac and symv_ms > 0 and eff > 0


@pytest.mark.cuda
def test_coo_hvp_nnz_per_s_on_card(cuda_device):
    assert tb.coo_hvp_nnz_per_s(SMALL, device=cuda_device) > 0
