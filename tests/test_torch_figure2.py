"""The port's Figure-2 tool against the JAX package's tool: the curve,
certification and merge functions on the same numpy inputs, and the whole
grid of a small Gram-path and a small d-space problem in fp64 on the CPU."""

import importlib.util
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg
from krylov_crn_tpu_torch.solvers import sscn as tsscn
from krylov_crn_tpu_torch.tools import run_figure2 as rf

REPO = Path(__file__).resolve().parent.parent
TRAJ_TOL = 1e-10  # fp64 loss trajectories of the two packages


@pytest.fixture(scope="module")
def jrf():
    """The JAX package's tool (a script, loaded from its file)."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_figure2", REPO / "tools" / "run_figure2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(rng, k=7, exact=True, xs=None):
    its = list(range(k))
    tr = types.SimpleNamespace(
        its=its, ts=list(np.cumsum(rng.random(k))),
        loss_vals=np.sort(rng.random(k))[::-1].astype(np.float32),
        metrics={}, xs=xs if xs is not None else [])
    if exact:
        tr.metrics = {"exact_its": [2, 4, 6, 9],
                      "exact_fs": list(rng.random(4))}
    return tr


@pytest.mark.parametrize("exact", [True, False])
def test_curve_of_equals_jax_tool(jrf, exact):
    tr = _trace(np.random.default_rng(0), exact=exact)
    got, want = rf.curve_of(tr), jrf.curve_of(tr)
    # exact_ts of an iteration missing from the trace is NaN in both
    assert json.dumps(got) == json.dumps(want)
    assert ("exact_fs" in got) == exact


@pytest.mark.parametrize("l2", [0.0, 1e-2])
def test_certify_iterate_curve_equals_jax_tool(jrf, l2):
    rng = np.random.default_rng(1)
    A, b = synthetic_logreg((120, 90, 900), seed=3)
    xs = [rng.standard_normal(90).astype(np.float32) for _ in range(5)]
    xs.insert(2, np.zeros((3, 90)))  # a checkpoint that is no iterate
    tj = _trace(rng, k=6, exact=False, xs=xs)
    tt = _trace(rng, k=6, exact=False,
                xs=[torch.from_numpy(x) for x in xs])
    want = jrf.certify_iterate_curve(tj, A, b, l2=l2)
    got = rf.certify_iterate_curve(tt, A, b, l2=l2)
    assert got == want
    assert tt.metrics == tj.metrics
    assert tt.metrics["exact_its"] == [0, 1, 3, 4, 5]


def _curves(rng, names, best):
    out = {}
    for i, name in enumerate(names):
        fs = list(best + 0.1 * rng.random(5) + 0.01 * i)
        out[name] = {"its": list(range(5)), "ts": list(range(5)), "fs": fs}
        if i % 2:
            out[name].update(exact_its=[4], exact_ts=[4.0],
                             exact_fs=[fs[-1]])
    return out


def test_merge_json_equals_jax_tool_and_shares_f_star(jrf, tmp_path, capsys):
    rng = np.random.default_rng(2)
    names = ["CRN", "Krylov CRN (m=10)", "SSCN (m=10)"]
    legs = [("h100-fp32", _curves(rng, names, 0.31), 0.3105),
            ("cpu-fp64", _curves(rng, names, 0.30), 0.3001)]
    meta = {"n": 10, "d": 20, "nnz": 30, "it_max": 5}
    datas = {}
    for mod, key in ((rf, "port"), (jrf, "jax")):
        path = tmp_path / f"{key}.json"
        for leg, curves, f_best in legs:
            datas[key] = mod.merge_json(str(path), "toy", leg, curves,
                                        f_best, meta)
        with open(path) as fh:
            assert json.load(fh) == json.loads(json.dumps(datas[key]))
    for d in datas.values():
        for leg in d["legs"].values():
            leg.pop("recorded")
    assert datas["port"] == datas["jax"]
    d = datas["port"]
    assert d["f_star"] == min(0.3105, 0.3001)
    assert set(d["legs"]) == {"h100-fp32", "cpu-fp64"}
    assert d["fp64_verified"]["cpu-fp64"]["CRN"] is True
    assert d["fp64_verified"]["h100-fp32"]["CRN"] is False
    assert d["fp64_verified"]["h100-fp32"]["Krylov CRN (m=10)"] is True
    # a leg whose f_best is above its own curves shows as a negative gap
    capsys.readouterr()
    rf.merge_json(str(tmp_path / "neg.json"), "toy", "cpu-fp64",
                  _curves(rng, names, 0.2), 0.5, meta)
    assert "negative final gaps" in capsys.readouterr().out


def _replay_jax_coordinates(monkeypatch):
    """The port's SSCN draws what the JAX package's would: each run's
    generator (seeded per run) maps to the JAX key of that seed."""
    keys = {}

    def draw(generator, d, m, device):
        _, key = keys.get(id(generator),
                          (generator,
                           jax.random.PRNGKey(generator.initial_seed())))
        key, sub = jax.random.split(key)
        I = np.array(jax.random.choice(sub, d, shape=(m,), replace=False),
                     np.int64)
        keys[id(generator)] = (generator, key)  # keeps the id unique
        return torch.from_numpy(I).to(device)

    monkeypatch.setattr(tsscn, "draw_coordinates", draw)


@pytest.mark.parametrize("shape,it_max,gram", [
    ((400, 900, 8000), 6, True),  # topic profile, n <= 4d: the Gram path
    ((300, 40, 3000), 6, False),  # d < 500: the d-space path, CRN "full"
], ids=["gram", "dense"])
def test_run_ours_matches_jax_tool_fp64(jrf, monkeypatch, tmp_path, shape,
                                        it_max, gram):
    import krylov_crn_tpu.config as jconfig

    # the JAX tool would point XLA's persistent cache outside the checkout
    monkeypatch.setattr(jconfig, "enable_compilation_cache", lambda: None)
    _replay_jax_coordinates(monkeypatch)
    A, b = synthetic_logreg(shape, seed=3, profile="topic" if gram else None)
    x0 = np.ones(A.shape[1]) * 0.5
    assert rf.use_gram(*A.shape) == gram
    dims = [8]
    want, f_want = jrf.run_ours(A, b, x0, it_max, dims, np.float64,
                                "cpu-fp64")
    got, f_got = rf.run_ours(A, b, x0, it_max, dims, np.float64, "cpu")
    assert list(got) == list(want) == [
        "CRN", "Krylov CRN (m=10)", "Benchmark Krylov CRN (m=20)",
        "SSCN (m=8)"]
    for name in got:
        assert got[name]["its"] == want[name]["its"], name
        for key in ("fs", "exact_fs"):
            assert (key in got[name]) == (key in want[name]), (name, key)
            if key in got[name]:
                np.testing.assert_allclose(got[name][key], want[name][key],
                                           rtol=0, atol=TRAJ_TOL,
                                           err_msg=f"{name} {key}")
    assert abs(f_got - f_want) <= TRAJ_TOL
    # the d-space path and SSCN certify their stored iterates
    assert ("exact_fs" in got["CRN"]) == (not gram)
    assert "exact_fs" in got["SSCN (m=8)"]

    # two legs merged: f* is the smaller of the two f_best
    path = str(tmp_path / "toy.json")
    rf.merge_json(path, "toy", "cpu-fp64", got, f_got, {"n": shape[0]})
    data = rf.merge_json(path, "toy", "h100-fp32", got, f_got + 1e-3,
                         {"device_h100-fp32": "some card, 700.00 W"})
    assert data["f_star"] == min(f_got, f_got + 1e-3) == f_got
    assert data["device_h100-fp32"] == "some card, 700.00 W"
    assert all(g >= -1e-12 for g in data["final_gaps"]["cpu-fp64"].values())


@pytest.mark.parametrize("dtype,all_certified,want", [
    (np.float32, True, 0.31),   # fp32 readings never define f*
    (np.float32, False, 0.30),  # an uncertified curve: f_opt holds its best
    (np.float64, True, 0.30),   # as the JAX tool, whose f_opt is fp64 here
])
def test_leg_f_best_takes_fp64_grade_values_only(dtype, all_certified, want):
    loss = types.SimpleNamespace(f_opt=0.30, dtype=np.dtype(dtype))
    curves = {"Krylov CRN (m=10)": {"fs": [0.2], "exact_fs": [0.32, 0.31]},
              "CRN": {"fs": [0.2], "exact_fs": [0.33]}}
    if not all_certified:
        del curves["CRN"]["exact_fs"]
    assert rf.leg_f_best(loss, curves) == want


def test_grid_is_the_jax_tools(jrf):
    assert rf.GRID == jrf.GRID and rf.REF_T_MAX == jrf.REF_T_MAX
    assert rf.OUT_DIR != "artifacts/figure2"
    A, b, x0 = rf.build_problem("w8a-like")
    Aj, bj, x0j = jrf.build_problem("w8a-like")
    assert (A != Aj).nnz == 0 and np.array_equal(b, bj)
    assert np.array_equal(x0, x0j)


def test_make_loss_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        rf.make_loss(*synthetic_logreg((50, 30, 200), seed=0),
                     np.float32)
