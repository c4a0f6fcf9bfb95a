"""BENCHMARK.json against the benchmark's contract, and the harness's
loader, result line and import guards."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, profile_reduce

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
        assert "mfu" not in n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).exists()
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def _cells_of(metric):
    return set(metric.get("workloads", [w["name"] for w in SPEC["workloads"]]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w["name"] in _cells_of(m) for m in SPEC["per_layer"])
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert _cells_of(m) <= _cells_of(moved), m["name"]


def test_news20_gram_reads_its_solve_per_layer():
    solve = next(m for m in SPEC["end_to_end"] if m["name"] == "solve_s")
    assert "news20.gram_krylov" not in solve["workloads"]
    paced = next(m for m in SPEC["per_layer"]
                 if m["name"] == "solve_s.host_paced")
    assert paced["workloads"] == ["news20.gram_krylov"]


def test_every_name_has_its_files():
    bench = REPO / "benchmark"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in SPEC["workloads"]:
        assert (bench / "limits" / f"{w['name']}.json").exists()
        tr = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        assert (bench / "drivers" / f"{tr['driver']}.py").exists()


@pytest.mark.parametrize("path", sorted(
    p.name for p in (REPO / "benchmark" / "drivers").glob("*.py")))
def test_every_driver_brings_its_calls_tiny_settings_and_control(path):
    driver = harness.load_module(REPO / "benchmark" / "drivers" / path)
    for name in ("setup", "solve", "traced", "release", "check", "control"):
        assert callable(getattr(driver, name)), name
    assert isinstance(driver.TINY, dict)


def test_file_names_are_made_of_name_characters():
    for p in (REPO / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_cell_added_as_files_alone_is_found(tiny_root, tmp_path):
    from conftest import make_root

    root = make_root(tmp_path / "root")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="rcv1-twin",
                                file="benchmark/configs/rcv1-twin.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="twin.race",
                                  config="rcv1-twin", traffic="race_b"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/rcv1-like.json").read_text())
    (bench / "configs/rcv1-twin.json").write_text(
        json.dumps(dict(cfg, name="rcv1-twin", n_rows=900)))
    tr = json.loads((bench / "traffic/gram_krylov_race.json").read_text())
    (bench / "traffic/race_b.json").write_text(json.dumps(dict(tr, chunk=8)))
    (bench / "limits/twin.race.json").write_text(
        (bench / "limits/rcv1.gram_krylov.json").read_text())
    cell = harness.load_cell("twin.race", root)
    assert cell["config"]["n_rows"] == 900
    assert cell["traffic"]["chunk"] == 8
    assert {m["name"] for m in cell["end_to_end"]} == {
        "peak_mem_gib", "setup_s"}
    with pytest.raises(harness.BenchError):
        harness.load_cell("no.such.cell", root)


def test_result_line_keys(tiny_root):
    res = harness.run("rcv1.gram_krylov", 11, 0.1, False, root=tiny_root,
                      device="cpu")
    assert list(res) == RESULT_KEYS + ["checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    # whatever this process imported before (the JAX package's tests may
    # share it) is left out for the test's length
    for k in list(sys.modules):
        if k.split(".", 1)[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, k, raising=False)
    fake = {"krylov_crn_tpu_torch": 1, "krylov_crn_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen.x": 1}
    for k in fake:
        monkeypatch.setitem(sys.modules, k, object())
    assert harness.forbidden_modules() == []
    for k in ("krylov_crn_tpu.ops.symv", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, k, object())
    assert harness.forbidden_modules() == sorted(
        ["krylov_crn_tpu.ops.symv", "jax.numpy", "jaxlib", "flax"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix() for p in (REPO / "benchmark").rglob("*.py")
    if "tests" not in p.parts))
def test_no_file_imports_jax_or_the_jax_package(path):
    for mod in _imports(REPO / path):
        assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)
    text = (REPO / path).read_text()
    assert "BENCH_" not in text and "bench.py" not in text


@pytest.mark.parametrize("name", ["reference", "datagen", "peaks"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    for mod in _imports(REPO / "benchmark" / f"{name}.py"):
        assert mod.split(".")[0] not in (harness.PROGRAM,) + harness.FORBIDDEN
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import benchmark.{name}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & {harness.PROGRAM, *harness.FORBIDDEN}


def test_union_gaps():
    busy, gaps = profile_reduce.union_gaps(
        [(1, 3), (2, 4), (6, 7), (9, 12)], 0, 10)
    assert busy == 3 + 1 + 1
    assert gaps == [(0, 1), (4, 6), (7, 9)]
