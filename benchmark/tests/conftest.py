"""CPU tests of the benchmark's harness (``python -m pytest benchmark/tests``).

The ``cuda`` tests run a cell on a card and skip without one. ``tiny_root``
is a benchmark root whose configurations keep the shipped files' keys at a
size a CPU test holds, each at its generator's tiny shape
(``datagen.GENERATORS``), and whose traffic keeps the shipped mixes with
each driver's own ``TINY`` settings over them, with the shipped drivers,
metric readers and limits.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import datagen, harness  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def make_root(dst: Path) -> Path:
    """A benchmark root at ``dst`` like the repository's, at CPU size."""
    bench = dst / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    for sub in ("metrics", "drivers"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = datagen.tiny(json.loads((REPO / c["file"]).read_text()))
        (dst / c["file"]).write_text(json.dumps(cfg))
    for t in {w["traffic"] for w in spec["workloads"]}:
        tr = json.loads((REPO / "benchmark/traffic" / f"{t}.json").read_text())
        driver = harness.load_module(REPO / "benchmark/drivers"
                                     / f"{tr['driver']}.py")
        tr.update(driver.TINY)
        (bench / "traffic" / f"{t}.json").write_text(json.dumps(tr))
    for w in spec["workloads"]:
        shutil.copy(REPO / "benchmark/limits" / f"{w['name']}.json",
                    bench / "limits")
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
