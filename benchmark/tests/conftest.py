"""CPU tests of the benchmark's harness (``python -m pytest benchmark/tests``).

The ``cuda`` tests run a cell on a card and skip without one. ``tiny_root``
is a benchmark root whose configurations keep the shipped files' keys at a
size a CPU test holds (1,200 x 5,000, 30 topics; SSCN m = 100 for 20 steps),
with the shipped traffic's drivers, metric readers and limits.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = dict(n_rows=1200, n_features=5000, nnz_drawn=60000)
TINY_TOPICS = dict(R=30, n_clusters=5)
TINY_SSCN = dict(subspace_dim=100, steps=20)


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
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY, topic_params=dict(cfg["topic_params"], **TINY_TOPICS))
        (dst / c["file"]).write_text(json.dumps(cfg))
    for t in {w["traffic"] for w in spec["workloads"]}:
        tr = json.loads((REPO / "benchmark/traffic" / f"{t}.json").read_text())
        if tr["driver"] == "sscn_run":
            tr.update(TINY_SSCN)
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
