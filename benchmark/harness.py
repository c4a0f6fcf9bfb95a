"""The benchmark's engine: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to a cell is found by name: the configuration's
file (``configs/``, named in ``BENCHMARK.json``), the traffic mix
(``traffic/<traffic>.json``), which names its driver (``drivers/<driver>.py``:
set-up, one solve, the traced solve, the check), the limits of the cell's
comparison (``limits/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``). A later cell or metric is added as files and
entries alone.

A run: set-up (imports, the CUDA context, the configuration's data, the
program's kernels from the checkout's build cache, a warm solve), then
solves back to back for ``--seconds`` (closed loop, one client), then with
``--trace 1`` one more solve under ``torch.profiler``, then, once the
program's state is freed, what the driver's ``finish`` works out on the
benchmark's side (the Gram race's f*) and the check against the plain
reference. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.

Module-level imports are the standard library's only: ``run.py`` fixes the
host's thread pools from the configuration before numpy or torch load.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

__all__ = ["ROOT", "FORBIDDEN", "load_cell", "load_module", "environment",
           "forbidden_modules", "Context", "mean_of", "idle_pct", "run",
           "main"]

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "krylov_crn_tpu")
PROGRAM = "krylov_crn_tpu_torch"


class BenchError(Exception):
    """A run that cannot produce a result (exit code 2)."""


def _json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with everything
    its name leads to: ``cell``, ``config`` (the configuration's file),
    ``traffic``, ``limits``, and the cell's ``end_to_end`` and
    ``per_layer`` metric entries."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    config = _json(root / entry["file"])
    bench = root / spec["paths"][0]

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return dict(
        spec=spec, cell=cell, config=config, config_entry=entry,
        traffic=_json(bench / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
        bench=bench)


def load_module(path: Path):
    """The Python file ``path`` as a module (metric names hold dots)."""
    name = "benchmark_" + "".join(ch if ch.isalnum() else "_"
                                  for ch in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def environment(cell: dict, root: Path = ROOT) -> dict:
    """The run's environment settings, applied to ``os.environ`` before
    numpy or torch load: the host's thread pools as the configuration
    states them, and every kernel cache at a fixed path inside the
    checkout."""
    threads = str(cell["config"]["host_threads"])
    cache = root / ".bench_cache"
    env = {name: threads for name in (
        "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
        "NUMEXPR_NUM_THREADS")}
    env.update(TRITON_CACHE_DIR=str(cache / "triton"),
               TORCH_EXTENSIONS_DIR=str(cache / "torch_extensions"),
               CUDA_CACHE_PATH=str(cache / "cuda"),
               USE_FLAX="0", USE_JAX="0")
    os.environ.update(env)
    return env


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unknown ({type(exc).__name__})"
    return out.stdout.strip().replace("\n", "; ") or "unknown"


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What a driver and the metric readers see of one run."""

    def __init__(self, cell: dict, seed: int, device):
        import numpy as np

        self.cell = cell
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.device = device
        self.parts = []  # (set-up part, seconds)
        self.solves = []  # one record per solve in the window
        self.kept = None  # the sampled solve's outputs, on the host
        self.profile = None  # the traced solve's reduced trace
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.facts = {}
        # the sample of solves to check, one kept at a time (reservoir)
        self._keep_rng = np.random.default_rng([self.seed, 17])

    def rng(self, *tag):
        """A numpy generator of this run's seed and ``tag``."""
        import numpy as np

        return np.random.default_rng([self.seed, *tag])

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def part(self, name: str):
        """Time a part of the set-up, to a synchronize at its end; printed
        at once."""
        t0 = time.perf_counter()
        yield
        self.sync()
        dt = time.perf_counter() - t0
        self.parts.append((name, dt))
        log(f"setup: {name} {dt:.4f} s")

    def keep_this(self, i: int) -> bool:
        """Whether solve ``i`` replaces the kept sample: every solve of
        the window is kept with the same chance, drawn from the seed."""
        return int(self._keep_rng.integers(i + 1)) == 0

    def load_kernels(self, names):
        """The program's kernel libraries (built with nvcc into the
        checkout's build cache on a first run)."""
        if self.device.type != "cuda":
            return
        from krylov_crn_tpu_torch.ops._kernels import (
            last_build_seconds,
            load_library,
        )

        for name in names:
            load_library(name)
        built = {k: round(v, 3) for k, v in last_build_seconds.items()}
        self.facts["kernel_builds_s"] = built


def mean_of(ctx: Context, key: str):
    """The mean of ``key`` over the window's solves that hold it, or None:
    the readers' one statistic of a solve record."""
    vals = [s[key] for s in ctx.solves if s.get(key) is not None]
    return sum(vals) / len(vals) if vals else None


def idle_pct(ctx: Context):
    """The device's idle share of the traced solve in %, or None."""
    if not ctx.profile:
        return None
    return 100.0 * (1.0 - ctx.profile["busy_s"] / ctx.profile["window_s"])


def _span_factory(traced: bool):
    if not traced:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function(f"bench::{name}")


def _profile(ctx: Context, driver):
    """One solve under torch.profiler, reduced (``profile_reduce``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import profile_reduce

    ctx.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_reduce.pad()
        with torch.profiler.record_function("bench::solve"):
            driver.traced(ctx, _span_factory(True))
        ctx.sync()
    return profile_reduce.reduce(prof)


def _metrics(ctx: Context, entries, bench: Path) -> dict:
    out = {}
    for m in entries:
        reader = load_module(bench / "metrics" / f"{m['name']}.py")
        value = reader.read(ctx)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise BenchError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: Path = ROOT, device=None, t_start=None) -> dict:
    """One run; returns the result object. ``device`` (tests): run there
    and skip the look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(workload, root)
    import numpy as np  # noqa: F401  (after the thread settings)
    import torch

    t_torch = time.perf_counter()

    chips = int(cell["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: torch.cuda.is_available() is "
                             "False")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"{workload} needs {chips} cards, "
                             f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    __import__(PROGRAM)
    driver = load_module(cell["bench"] / "drivers"
                         / f"{cell['traffic']['driver']}.py")
    ctx = Context(cell, seed, device)
    ctx.parts += [("import_torch", t_torch - t_start),
                  ("import_program", time.perf_counter() - t_torch)]
    for name, dt in ctx.parts:
        log(f"setup: {name} {dt:.4f} s")
    with ctx.part("cuda_context"):
        torch.zeros(1, device=device).add_(1)
    driver.setup(ctx)
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start
    rest = ctx.setup_s - sum(t for _, t in ctx.parts)
    log(f"setup: other {rest:.4f} s")
    log(f"setup: total {ctx.setup_s:.4f} s")

    # a finished solve's objects in reference cycles (the step graphs and
    # their memory pools) are collected before the next, as its process's
    # end would: else the collector's timing decides which solve's K build
    # meets a predecessor's pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    span = _span_factory(False)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ctx.solves.append(driver.solve(ctx, len(ctx.solves), span))
        gc.collect()
    ctx.window_s = time.perf_counter() - t0
    ctx.peak_bytes = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else 0)
    if trace:
        ctx.profile = _profile(ctx, driver)

    driver.release(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    finish = getattr(driver, "finish", None)
    if finish is not None:
        t_finish = time.perf_counter()
        finish(ctx)
        log(f"after window: finish {time.perf_counter() - t_finish:.4f} s")
    found = driver.check(ctx)
    limits = cell["limits"]
    if not set(limits) <= set(found):
        raise BenchError(f"checks {sorted(found)} against limits "
                         f"{sorted(limits)}")
    for k in sorted(set(found) - set(limits)):
        log(f"reading {k} {found[k]!r} (not compared)")
    checks = {k: found[k] for k in limits}
    failed = sum(1 for s in ctx.solves if s.get("failed"))
    correct = failed == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    metrics = _metrics(ctx, cell["per_layer"] if trace
                       else cell["end_to_end"], cell["bench"])
    device_facts = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu"),
                    "count": chips,
                    "memory_peak_bytes": int(ctx.peak_bytes)}
    result = {"correct": bool(correct), "attempted": len(ctx.solves),
              "failed": failed, "metrics": metrics, "device": device_facts}
    if trace:
        device_facts["busy_s"] = ctx.profile["busy_s"]
        device_facts["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = ctx.profile["breakdown"]
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    ctx.facts.update(
        cpus=os.cpu_count(), torch_threads=torch.get_num_threads(),
        omp=os.environ.get("OMP_NUM_THREADS"),
        blas=os.environ.get("OPENBLAS_NUM_THREADS"),
        mkl=os.environ.get("MKL_NUM_THREADS"),
        card=_power_limit() if device.type == "cuda" else "none",
        solves=len(ctx.solves), window_s=round(ctx.window_s, 4))
    log("host: " + json.dumps(ctx.facts))
    log("solves: " + json.dumps(
        [{k: v for k, v in s.items() if not isinstance(v, (list, dict))}
         for s in ctx.solves]))
    return result


def main(argv=None, t_start=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    except BenchError as exc:
        log(f"benchmark: {exc}")
        return 2
    found = forbidden_modules()
    if found:
        log("benchmark: forbidden modules loaded: " + ", ".join(found))
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
