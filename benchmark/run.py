"""Run one cell of the benchmark on the card this process is started on.

    python3 benchmark/run.py --workload rcv1.gram_krylov --seed 7 --seconds 40 --trace 0

Prints the set-up's parts, the host's facts and the numbers compared on
standard error, and the result as the last line of standard output (see
``benchmark/harness.py``). Exits 2, printing no result, without a card or
the cards the cell needs; 4 if the JAX package or JAX was loaded. Python's
compiled modules, like the program's kernels, are cached in
``.bench_cache/`` inside the checkout, so that only a checkout's first run
compiles them.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Python's compiled modules go to a fixed directory of the checkout, as the
# kernel caches do, even where the environment turns bytecode off: else
# every run compiles torch's sources anew, seconds of set-up that vary
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")


def _main() -> int:
    from benchmark import harness

    args = sys.argv[1:]
    workload = args[args.index("--workload") + 1] if "--workload" in args \
        else None
    if workload is not None:
        try:
            harness.environment(harness.load_cell(workload))
        except (harness.BenchError, OSError, KeyError, ValueError) as exc:
            harness.log(f"benchmark: {exc}")
            return 2
    return harness.main(t_start=T_START)


if __name__ == "__main__":
    sys.exit(_main())
