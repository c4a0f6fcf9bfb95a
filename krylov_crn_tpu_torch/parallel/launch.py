"""Start N ranks of one function on this host and join them.

``run_ranks(fn, world, backend, device, timeout, *args)`` starts ``world``
processes with the ``spawn`` start method. Each joins one
``torch.distributed`` process group through a ``file://`` rendezvous in a
temporary directory (no TCP port, so several launches can run beside each
other on one host), builds its ``Mesh`` and calls ``fn(mesh, *args)``.
``backend``, ``device`` and ``timeout`` are always given; ``None`` for the
device means the card, never the CPU.
The results come back in rank order. A rank that raises, or a join that
passes ``timeout`` seconds, ends every rank and raises here with each
rank's traceback.

``fn`` and ``args`` are pickled into the children, so ``fn`` is a
module-level function. Used by the tests, the CLI's ``--mesh``, the
multi-device tools and ``chip_smoke.py``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

from krylov_crn_tpu_torch.config import resolve_device

__all__ = ["run_ranks", "rank_device", "backend_for", "card_layout"]


def rank_device(device: str, rank: int) -> str:
    """This rank's device: ``"cpu"`` and an indexed ``"cuda:k"`` are taken
    as they are (ranks may share a card); a bare ``"cuda"`` gives each rank
    the card of its own index."""
    return f"cuda:{rank}" if device == "cuda" else device


def backend_for(device: str) -> str:
    """The backend of a launch on ``device``: NCCL where every rank has a
    card of its own (``"cuda"``), gloo on the CPU and on one shared card
    (NCCL refuses two ranks on one device)."""
    return "nccl" if device == "cuda" else "gloo"


def card_layout(world: int) -> str:
    """``run_ranks``'s ``device`` for ``world`` ranks on this host's cards:
    ``"cuda"`` (a card per rank) when it has that many, else the shared
    ``"cuda:0"``."""
    import torch

    return "cuda" if torch.cuda.device_count() >= world else "cuda:0"


def _rank_main(fn, rank, world, backend, device, timeout, rdv, args):
    out = os.path.join(rdv, f"rank{rank}")
    try:
        import torch
        import torch.distributed as dist

        from krylov_crn_tpu_torch.parallel.mesh import make_mesh

        dev = rank_device(device, rank)
        if dev == "cpu":
            # the ranks share this host's cores
            torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                             (os.cpu_count() or 1) // world)))
        else:
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(
            backend, init_method=f"file://{rdv}/rendezvous",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(world, dev), *args)
            with open(out + ".tmp", "wb") as fh:
                pickle.dump(result, fh)
            os.replace(out + ".tmp", out + ".pkl")
            # leave together: a rank that exits early tears down the
            # others' pending transfers
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(out + ".err", "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _prebuild_kernels():
    """Build (or find built) the CUDA kernels once in the parent, so the
    ranks load the finished libraries instead of running nvcc side by
    side."""
    from krylov_crn_tpu_torch.ops._kernels import load_library

    for name in ("symv", "matvec"):
        load_library(name)


def run_ranks(fn, world: int, backend: str | None, device: str | None,
              timeout: float, *args) -> list:
    """``[fn(mesh, *args) for each rank]``; see the module docstring.

    ``device=None`` is this host's cards (``card_layout``; without a card
    it raises) and ``backend=None`` the backend that goes with the device
    (``backend_for``). The ranks run on the CPU only for ``device="cpu"``."""
    if world < 1:
        raise ValueError(f"run_ranks: world must be >= 1, got {world}")
    if device is None:
        resolve_device(None)
        device = card_layout(world)
    if backend is None:
        backend = backend_for(device)
    if device != "cpu":
        _prebuild_kernels()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kcrn_ranks_") as rdv:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, device, timeout,
                                   rdv, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            failed = False
            while time.monotonic() < deadline and not failed:
                alive = [p for p in procs if p.is_alive()]
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if not alive:
                    break
                alive[0].join(0.05)
            timed_out = any(p.is_alive() for p in procs) and not failed
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(rdv, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as fh:
                    errors.append(f"--- rank {r} ---\n{fh.read()}")
            elif p.exitcode != 0:
                errors.append(f"--- rank {r} --- exit code {p.exitcode}"
                              + (" (killed at the time limit)"
                                 if timed_out else ""))
        if errors or timed_out:
            head = (f"run_ranks: {fn.__name__} passed its {timeout:g} s limit"
                    if timed_out else f"run_ranks: {fn.__name__} failed")
            raise RuntimeError(head + " on " + f"{world} ranks\n"
                               + "\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(rdv, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
