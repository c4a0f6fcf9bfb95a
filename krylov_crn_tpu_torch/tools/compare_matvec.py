"""The dense matvec kernel of two checkouts side by side on one card.

    python -m krylov_crn_tpu_torch.tools.compare_matvec --other DIR [--out F]

Times ``ops/matvec.matvec`` of this checkout and of the checkout at DIR
(a directory holding another ``krylov_crn_tpu_torch``, e.g. the parent
commit unpacked with ``git archive``) at the shapes the port's paths run
it at, each in a process of its own, in the order other, this, this,
other, so that both versions meet the same card in turns:

* ``band``    (5120, 20480) fp32, the row band of rcv1-like's K under a
  mesh of four;
* ``w8a_A``   (49749, 300) fp32 and ``w8a_At`` (300, 49749) fp32 with a
  leading dimension of 49752, w8a-like's padded dense copies;
* ``sq_f32``  and ``sq_bf16``, (20480, 20480) with fp32 and bf16 K.

Each time is the median of 25 calls timed with CUDA events, each call
finding the L2 cache cold (``utils/profiling.device_time_per_call`` with
``flush_l2``, always this checkout's, so that both versions are timed
alike); ``torch.mv`` on the same K and x (on K.float() for bf16) is timed
beside it in every process. Prints one JSON line per process, the card's
name and power limit, and a table; ``--out`` also writes the JSON.

    python -m krylov_crn_tpu_torch.tools.compare_matvec --profile [--out F]

looks into this checkout's kernel at the band and w8a's shapes instead:
the device time of each kernel that it and ``torch.mv`` launch, from
``torch.profiler``; its fixed cost (a (16, 300) and an (8, 49749)
product, a few units each); w8a's A^T with rows 96 bytes past a 128-byte
line (ld 49,752, as the port stores it) against rows on a line (ld
49,760); and other plans (``ops/matvec.make_plan``: rows per tile,
vectors per chunk, blocks) at the three shapes, each checked against an
fp64 product. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

SHAPES = {"band": (5120, 20480, "float32"), "w8a_A": (49749, 300, "float32"),
          "w8a_At": (300, 49749, "float32"),
          "sq_f32": (20480, 20480, "float32"),
          "sq_bf16": (20480, 20480, "bfloat16")}
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (rows per tile, 16-byte vectors per chunk, blocks) tried by --profile
PLANS = {"w8a_A": [(tr, 75, g) for tr in (8, 16, 32)
                   for g in (132, 264, 396)],
         "w8a_At": [(tr, tcv, g) for tr, tcv in ((8, 64), (8, 128), (8, 256),
                                                  (16, 128))
                    for g in (132, 264, 396)],
         "band": [(8, tcv, g) for tcv in (128, 256) for g in (264, 396)]}


def _profiling():
    """This checkout's utils/profiling, whichever package is importable."""
    spec = importlib.util.spec_from_file_location(
        "_compare_profiling",
        os.path.join(HERE, "krylov_crn_tpu_torch", "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(name, dev, gen):
    """K and x of a shape; w8a's copies padded as the port pads them."""
    import torch

    from krylov_crn_tpu_torch.data.formats import padded_dense

    n, m, dtype = SHAPES[name]
    if name.startswith("w8a"):
        A = torch.randn((49749, 300), generator=gen, device=dev)
        K = padded_dense(A if name == "w8a_A" else A.T, dev)
    else:
        K = torch.randn((n, m), generator=gen, device=dev).to(
            getattr(torch, dtype))
    return K, torch.randn(m, generator=gen, device=dev)


def _rel(y, K, x):
    import torch

    ref = K.double() @ x.double()
    return float(torch.linalg.norm(y.double() - ref)
                 / torch.linalg.norm(ref))


def _bound_ms(K, prof):
    n, m = K.shape
    return (n * m * K.element_size() + 4 * (n + m)) / prof.HBM_BYTES_PER_S \
        * 1e3


def worker() -> dict:
    """This process's times: the importable package's kernel and
    torch.mv at every shape."""
    import torch

    from krylov_crn_tpu_torch.ops.matvec import matvec

    prof = _profiling()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"package": os.path.dirname(os.path.dirname(
        sys.modules["krylov_crn_tpu_torch"].__file__))}
    for name in SHAPES:
        K, x = _operands(name, dev, gen)
        Kf = K if K.dtype == torch.float32 else K.float()
        out[name] = dict(
            kernel_ms=prof.device_time_per_call(lambda v: matvec(K, v), x,
                                                flush_l2=True),
            torch_mv_ms=prof.device_time_per_call(lambda v: torch.mv(Kf, v),
                                                  x, flush_l2=True),
            bound_ms=_bound_ms(K, prof), rel_err=_rel(matvec(K, x), K, x))
        del K, Kf
    return out


def _device_kernels(fn, x, calls=20):
    """{kernel name: (launches, mean device us)} over ``calls`` calls of
    fn(x) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    out = {}
    for ev in p.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0 and ev.count:
            out[ev.key] = (ev.count, t / ev.count)
    return out


def profile_kernel() -> dict:
    """--profile's records (see the module's docstring)."""
    import torch

    from krylov_crn_tpu_torch.ops.matvec import (
        blocks_per_sm,
        make_plan,
        matvec,
        smem_bytes,
        split_plan,
    )

    prof = _profiling()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"profiler": {}, "fixed": {}, "plans": {}}
    for name in ("band", "w8a_A", "w8a_At"):
        K, x = _operands(name, dev, gen)
        out["profiler"][name] = dict(
            kernel=_device_kernels(lambda v: matvec(K, v), x),
            torch_mv=_device_kernels(lambda v: torch.mv(K, v), x),
            bound_us=_bound_ms(K, prof) * 1e3)
        n, m = K.shape
        rows = []
        for tr, tcv, g in [(None, None, None)] + PLANS[name]:
            p = (split_plan(n, m, 4) if tr is None
                 else make_plan(n, m, 4, tr, tcv, g))
            y = matvec(K, x, plan=p)
            ms = prof.device_time_per_call(
                lambda v: matvec(K, v, plan=p), x, flush_l2=True)
            rows.append(dict(plan=p._asdict(), default=tr is None, ms=ms,
                             share=_bound_ms(K, prof) / ms,
                             blocks_per_sm=blocks_per_sm(
                                 K, smem_bytes(p, 4)),
                             rel_err=_rel(y, K, x)))
        out["plans"][name] = rows
        if name == "w8a_At":
            # the same rows, each starting on a 128-byte line
            K2 = torch.zeros((n, 49760), device=dev)
            K2[:, :m] = K
            K2 = K2[:, :m]
            out["aligned_rows"] = dict(
                ld=[K.stride(0), K2.stride(0)],
                ms=[prof.device_time_per_call(lambda v, A=A: matvec(A, v), x,
                                              flush_l2=True) for A in (K, K2)])
        del K
    for n, m in ((16, 300), (8, 49749)):
        K = torch.randn((n, m), generator=gen, device=dev)
        x = torch.randn(m, generator=gen, device=dev)
        out["fixed"][f"{n}x{m}"] = dict(
            kernel_ms=prof.device_time_per_call(lambda v: matvec(K, v), x),
            torch_mv_ms=prof.device_time_per_call(lambda v: torch.mv(K, v),
                                                  x),
            kernel=_device_kernels(lambda v: matvec(K, v), x),
            torch_mv=_device_kernels(lambda v: torch.mv(K, v), x))
    return out


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="a directory holding another "
                    "krylov_crn_tpu_torch to compare with")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="look into this checkout's kernel instead")
    ap.add_argument("--out", help="also write the records to this JSON")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker()))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_matvec: needs a CUDA device")
    if args.profile:
        rec = dict(card=_card(), **profile_kernel())
        print(json.dumps(rec))
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(rec, fh, indent=1)
        return 0
    order = ([("other", args.other), ("this", HERE), ("this", HERE),
              ("other", args.other)] if args.other else [("this", HERE)] * 2)
    runs = []
    for label, root in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker"], env=env, capture_output=True,
                             text=True, check=True)
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["label"] = label
        runs.append(rec)
        print(json.dumps(rec))
    card = _card()
    print(card)
    for name in SHAPES:
        row = {lab: [r[name]["kernel_ms"] for r in runs if r["label"] == lab]
               for lab in ("other", "this")}
        mv = [r[name]["torch_mv_ms"] for r in runs]
        bound = runs[0][name]["bound_ms"]
        print(f"{name:8s} bound {bound:.4f} ms | this "
              f"{[round(t, 4) for t in row['this']]} ms "
              f"({bound / min(row['this']):.1%}) | other "
              f"{[round(t, 4) for t in row['other']]} ms | torch.mv "
              f"{[round(t, 4) for t in mv]} ms")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, runs=runs), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
