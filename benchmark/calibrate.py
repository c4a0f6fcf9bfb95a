"""Readings behind the limits of a cell's comparison: the program's numbers
on many seeds, and the control's on some.

    python3 benchmark/calibrate.py --workload rcv1.gram_krylov --seeds 1 2 3 \
        --control-seeds 1 2 3 [--out calibrate.jsonl]

For each seed: the cell's set-up and one solve through its driver module, as
a run makes them, then that module's ``check`` (the lower reading). For a
control seed also the driver's ``control``: the check with the reference put
in the program's place one precision below the configuration's (the upper
reading). A driver whose ``check`` takes ``steps`` gives each step's
readings with ``--steps``.

One JSON line per seed on standard output (and in ``--out``). Needs the
card that the cell names, or ``--device cpu`` for a rehearsal at a small
size (``--root``).
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def one(workload, seed, with_control, root, device, steps=False,
        traffic=None):
    import torch

    cell = harness.load_cell(workload, root)
    cell["traffic"].update(traffic or {})
    dev = torch.device(device) if device else torch.device("cuda", 0)
    driver = harness.load_module(cell["bench"] / "drivers"
                                 / f"{cell['traffic']['driver']}.py")
    ctx = harness.Context(cell, seed, dev)
    takes_steps = "steps" in inspect.signature(driver.check).parameters
    per_step = {"program": [], "control": []} if steps and takes_steps \
        else None

    def diag(name):
        return {"steps": per_step[name]} if per_step else {}

    driver.setup(ctx)
    rec = driver.solve(ctx, 0, lambda name: contextlib.nullcontext())
    driver.release(ctx)
    finish = getattr(driver, "finish", None)
    if finish is not None:
        finish(ctx)
    out = {"workload": workload, "seed": seed, "solve": {
        k: v for k, v in rec.items() if not isinstance(v, (list, dict))},
        "facts": ctx.facts, "program": driver.check(ctx, **diag("program"))}
    if with_control:
        t0 = time.perf_counter()
        out["control"] = driver.control(ctx, **diag("control"))
        out["control_s"] = time.perf_counter() - t0
    if per_step:
        out["steps"] = per_step
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--root", default=str(harness.ROOT))
    ap.add_argument("--device")
    ap.add_argument("--steps", action="store_true",
                    help="every step's readings in the output, where the "
                         "driver's check gives them")
    ap.add_argument("--traffic", default="{}",
                    help="JSON object over the traffic's keys, e.g. "
                         "'{\"dtype\": \"float64\"}' for the program's fp64 run")
    args = ap.parse_args(argv)
    root = Path(args.root)
    harness.environment(harness.load_cell(args.workload, root), root)
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        res = one(args.workload, seed, seed in args.control_seeds, root,
                  args.device, args.steps, json.loads(args.traffic))
        line = json.dumps(res)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
