"""The harness driven end to end on the CPU at a small size: sound runs come
out correct, and the timed path broken underneath, or the control in the
program's place, comes out not correct."""

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
GRAM, SSCN = "rcv1.gram_krylov", "news20.sscn_m1000"


def _run(root, workload, seed=5, seconds=0.1):
    return harness.run(workload, seed, seconds, False, root=root,
                       device="cpu")


@pytest.mark.parametrize("workload", [GRAM, SSCN])
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


@pytest.mark.parametrize("workload", [GRAM, SSCN])
def test_the_control_is_not_correct(tiny_root, workload):
    out = calibrate.one(workload, 7, True, tiny_root, "cpu")
    limits = harness.load_cell(workload, tiny_root)["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items())
    assert any(out["control"][k] > v for k, v in limits.items()), out


def test_the_data_is_the_port_generators(tiny_root):
    from krylov_crn_tpu_torch.data.synthetic import synthetic_logreg

    cfg = harness.load_cell(GRAM, tiny_root)["config"]
    shape = (cfg["n_rows"], cfg["n_features"], cfg["nnz_drawn"])
    for seed in (0, 2 ** 31 + 3):
        A, b = datagen.make(dict(cfg, data_seed=seed))
        A2, b2 = synthetic_logreg(shape, seed=seed, profile="topic",
                                  topic_params=cfg["topic_params"])
        assert (A != A2).nnz == 0 and np.array_equal(b, b2)


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
