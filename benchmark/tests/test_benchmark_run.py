"""The harness driven end to end on the CPU at a small size: sound runs come
out correct, and the timed path broken underneath, or the control in the
program's place, comes out not correct. The data is the port's generators'
bits, and a configuration of another generator comes in as files alone."""

import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calibrate, datagen, harness, reference

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
GRAM, SSCN = "rcv1.gram_krylov", "news20.sscn_m1000"

# LIBSVM's w8a (the paper's Figure 2) as the port's "clustered" w8a-like:
# the configuration a later cell runs on, here at its published shape
W8A = {
    "name": "w8a-like",
    "source": "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/"
              "binary.html#w8a",
    "published": {"dataset": "w8a", "n_rows": 49749, "n_features": 300,
                  "nnz": 579586},
    "generator": "clustered",
    "data_seed": 0,
    "problem_version": 4,
    "n_rows": 49749,
    "n_features": 300,
    "nnz_drawn": 579586,
    "cluster_params": {"n_clusters": 50, "mix": 0.7,
                       "feats_per_cluster": 300},
    "conflict_frac": 0.02,
    "flip_frac": 0.005,
    "dtype": "float32",
    "host_threads": 4,
}
# the JAX package's fp64 optimum of w8a-like (PROBLEM_VERSION 4, seed 0;
# artifacts/figure2/w8a-like.json)
W8A_FSTAR = 0.5962522636038963


def _run(root, workload, seed=5, seconds=0.1):
    return harness.run(workload, seed, seconds, False, root=root,
                       device="cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny_root, workload):
    res = _run(tiny_root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = harness.load_cell(workload, tiny_root)
    # no device memory on the CPU: the run reports none
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]
                                   if m["name"] != "peak_mem_gib"}


def _gram_unchanged(mp):
    from krylov_crn_tpu_torch.solvers import krylov_gram

    mp.setattr(krylov_gram, "gram_krylov_step",
               lambda gd, state, **kw: state)


def _gram_altered(mp):
    from krylov_crn_tpu_torch.solvers import krylov_gram

    exact = krylov_gram._exact_value
    mp.setattr(krylov_gram, "_exact_value", lambda *a: (
        lambda v: (v[0] * (1 + 1e-7), v[1]))(exact(*a)))


def _gram_half_rows(mp):
    from krylov_crn_tpu_torch.solvers import krylov_gram

    build = krylov_gram.build_gram

    def half(A, *a, **kw):
        gd = build(A, *a, **kw)
        h = A.shape[0] // 2
        gd.K[h:] = 0
        gd.K[:, h:] = 0
        return gd

    mp.setattr(krylov_gram, "build_gram", half)


def _sscn_unchanged(mp):
    from krylov_crn_tpu_torch.solvers import sscn

    mp.setattr(sscn, "sscn_step", lambda data, b, state, I, **kw: state)


def _sscn_altered(mp):
    from krylov_crn_tpu_torch.solvers import sscn

    step = sscn.sscn_step

    def altered(*a, **kw):
        new = step(*a, **kw)
        return new._replace(x=new.x * (1 + 1e-4))

    mp.setattr(sscn, "sscn_step", altered)


def _sscn_half_rows(mp):
    from krylov_crn_tpu_torch.solvers import sscn

    partials = sscn.logreg_partials

    def half(data, b, Ax, x, I, l2=0.0, k_pad=None):
        g, H, B = partials(data, b, Ax, x, I, l2=l2, k_pad=k_pad)
        h = B.shape[0] // 2
        s = torch.sigmoid(Ax[:h])
        g = B[:h].T @ (s - b[:h]) / h
        H = (B[:h] * (s * (1 - s))[:, None]).T @ B[:h] / h
        return g.to(B.dtype), H.to(B.dtype), B

    mp.setattr(sscn, "logreg_partials", half)


FAULTS = {
    "gram_state_unchanged": (GRAM, _gram_unchanged),
    "gram_answer_altered": (GRAM, _gram_altered),
    "gram_half_the_rows_left_out": (GRAM, _gram_half_rows),
    "sscn_state_unchanged": (SSCN, _sscn_unchanged),
    "sscn_answer_altered": (SSCN, _sscn_altered),
    "sscn_half_the_rows_left_out": (SSCN, _sscn_half_rows),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    workload, plant = FAULTS[fault]
    plant(monkeypatch)
    res = _run(tiny_root, workload)
    assert not res["correct"], res["checks"]


def _control_fails(root, workload):
    out = calibrate.one(workload, 7, True, root, "cpu")
    limits = harness.load_cell(workload, root)["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    _control_fails(tiny_root, workload)


def _port_kwargs(cfg):
    """The port's ``synthetic_logreg`` arguments for a configuration."""
    from krylov_crn_tpu_torch.data import synthetic

    kw = dict(profile=cfg["generator"], conflict_frac=cfg["conflict_frac"],
              dtype=np.dtype(cfg["dtype"]))
    if cfg["generator"] == "topic":
        return dict(kw, topic_params=cfg["topic_params"])
    # the port's clustered profile takes clustered_sparse's defaults only
    defaults = {k: p.default for k, p in inspect.signature(
        synthetic.clustered_sparse).parameters.items()
        if k in cfg["cluster_params"]}
    assert cfg["cluster_params"] == defaults
    return dict(kw, flip_frac=cfg["flip_frac"])


def _same_problem(cfg, seed, port_args):
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    A, b = datagen.make(dict(cfg, data_seed=seed))
    A2, b2 = synthetic_logreg(port_args, seed=seed, **_port_kwargs(cfg))
    assert A.dtype == A2.dtype and A.shape == A2.shape
    assert (A != A2).nnz == 0 and np.array_equal(b, b2)


def _shape(cfg):
    return cfg["n_rows"], cfg["n_features"], cfg["nnz_drawn"]


@pytest.mark.parametrize("config", CONFIGS)
def test_the_data_is_the_port_generators(tiny_root, config):
    files = {c["name"]: c["file"] for c in SPEC["configs"]}
    cfg = json.loads((tiny_root / files[config]).read_text())
    for seed in (0, 2 ** 31 + 3):
        _same_problem(cfg, seed, _shape(cfg))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
@pytest.mark.parametrize("size", ["published", "tiny"])
def test_the_clustered_copy_is_the_ports_w8a_like(size, seed):
    if size == "published":
        _same_problem(W8A, seed, "w8a-like")
    else:
        cfg = datagen.tiny(W8A)
        assert _shape(cfg) == (1200, 300, 13980)
        _same_problem(cfg, seed, _shape(cfg))


def test_fstar_of_w8a_like_is_the_jax_packages():
    A, b = datagen.make(W8A)
    f, facts = reference.fstar(A, b, "cpu")
    assert facts["rank"] == W8A["n_features"]
    assert abs(f - W8A_FSTAR) <= 1e-12, (f, facts)


# sha256 of (indptr int64, indices int64, data fp32, b fp64) of each
# configuration's whole problem, from the generator before it dispatched
# on ``generator``: the timed problems keep their bits
PROBLEM_SHA256 = {
    "rcv1-like":
        "b0d5860a1591c4f334840ddc4fa07b93afbc093c8c240f2882493b948d710f94",
    "news20-like":
        "158ccb224fab85b4f0a19a37fadb8f1d3731852f4af074b6c436568c9b0cfeae",
}


@pytest.mark.parametrize("config", sorted(PROBLEM_SHA256))
def test_the_timed_problems_keep_their_bits(config):
    files = {c["name"]: c["file"] for c in SPEC["configs"]}
    A, b = datagen.make(json.loads((REPO / files[config]).read_text()))
    h = hashlib.sha256()
    for arr, dt in ((A.indptr, np.int64), (A.indices, np.int64),
                    (A.data, np.float32), (b, np.float64)):
        h.update(np.ascontiguousarray(arr, dt).tobytes())
    assert h.hexdigest() == PROBLEM_SHA256[config]


def test_a_configuration_is_refused_for_what_its_generator_lacks():
    with pytest.raises(ValueError, match="no-such"):
        datagen.make(dict(W8A, generator="no-such"))
    lacking = {k: v for k, v in W8A.items() if k != "cluster_params"}
    with pytest.raises(ValueError, match="cluster_params"):
        datagen.make(lacking)


def test_a_clustered_cell_comes_in_as_files_alone(tmp_path):
    """w8a-like and a cell on the shipped Gram race, added to a root as a
    configuration file, a limits file and two entries of BENCHMARK.json: a
    sound run is correct, and the driver's control is not."""
    from conftest import make_root

    root = make_root(tmp_path / "root")
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "w8a-like", "source": W8A["source"],
        "file": "benchmark/configs/w8a-like.json", "reduced": ["nnz"],
        "why": "w8a's 49,749 x 300 as the port's clustered rows"})
    spec["workloads"].append({
        "name": "w8a.gram_krylov", "config": "w8a-like",
        "traffic": "gram_krylov_race", "chips": 1,
        "why": "the Gram race on clustered rows of full rank"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs/w8a-like.json").write_text(
        json.dumps(datagen.tiny(W8A)))
    (bench / "limits/w8a.gram_krylov.json").write_text(
        (bench / "limits/rcv1.gram_krylov.json").read_text())
    res = _run(root, "w8a.gram_krylov")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    _control_fails(root, "w8a.gram_krylov")


def test_fstar_lies_below_a_solve(tiny_root):
    cfg = harness.load_cell(GRAM, tiny_root)["config"]
    A, b = datagen.make(cfg)
    f, facts = reference.fstar(A, b, "cpu")
    assert facts["rank"] == cfg["topic_params"]["R"]
    x0 = np.full(A.shape[1], 0.5)
    assert f < reference.value(A, reference.labels01(b), x0)


def test_run_py_without_a_card_exits_with_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", GRAM, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_py_outside_a_checkout_exits_with_no_result(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", GRAM, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert proc.returncode != 0 and proc.stdout == ""
    # compiled modules are cached inside the checkout all the same
    cache = tmp_path / ".bench_cache" / "pycache"
    assert list(cache.rglob("harness*.pyc")), proc.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", SSCN, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
