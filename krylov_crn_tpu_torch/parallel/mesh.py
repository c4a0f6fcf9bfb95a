"""The 1-D mesh of ranks and the collectives the port uses.

Counterpart of ``krylov_crn_tpu/parallel/mesh.py``. Where the JAX package
lays arrays over a device mesh inside one process and lets GSPMD insert the
collectives, the port runs one process per rank and calls each collective
itself, through the ``torch.distributed`` process group the ``Mesh`` holds
(never the implicit global one). NCCL where every rank has a card of its
own; gloo on the CPU and where ranks share one card (NCCL refuses two ranks
on one device).

A mesh of one rank needs no process group (``make_mesh`` gives it none):
every collective is then the identity, so single-device code paths never
touch ``torch.distributed``.

**Replicated means bitwise equal.** The solvers branch on host reads of
replicated values (line-search accepts, secular Newton stops). Two ranks
that read different booleans would call different collectives and hang,
so every collective here hands all ranks identical bytes, and pairs are
folded in a fixed rank order.

**gloo and tensors on a card.** gloo moves bytes between host buffers:
what it does with a CUDA tensor it does through a host copy, and which
collectives it takes on CUDA tensors at all depends on the build
(PyTorch's table lists no all-gather, though a 2.11 build on an H100
machine took one). So under
gloo every collective on a CUDA tensor is staged in the open, the same
way on every build: device to host, the collective on the host copy, host
to device. It is counted like any other.

Each collective is counted on the mesh (``Mesh.counts``: calls, payload
bytes and the largest payload in elements, per kind), the port's stand-in
for reading the collectives out of compiled HLO.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from krylov_crn_tpu_torch.config import resolve_device

__all__ = ["Mesh", "make_mesh", "single", "all_reduce_sum", "all_reduce_max",
           "all_gather_rows", "all_gather_host", "broadcast_scalar",
           "KINDS"]

KINDS = ("all_reduce", "all_gather", "broadcast")


def _zero_counts():
    return {k: {"calls": 0, "bytes": 0, "max_numel": 0} for k in KINDS}


@dataclasses.dataclass
class Mesh:
    """One rank's view of the 1-D "data" mesh."""

    group: object | None  # torch.distributed.ProcessGroup; None when alone
    rank: int
    world: int
    device: torch.device  # where this rank keeps its tensors
    backend: str | None  # "gloo" / "nccl"; None when alone
    counts: dict = dataclasses.field(default_factory=_zero_counts)

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group; False for the
        mesh of one rank, whose collectives are the identity."""
        return self.group is not None

    def reset_counts(self) -> None:
        self.counts = _zero_counts()

    def counts_snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.counts.items()}

    def _count(self, kind: str, numel: int, itemsize: int) -> None:
        c = self.counts[kind]
        c["calls"] += 1
        c["bytes"] += numel * itemsize
        c["max_numel"] = max(c["max_numel"], numel)


def single(device=None) -> Mesh:
    """The mesh of one rank (no process group), on ``cuda:0`` unless
    ``device`` says otherwise."""
    return Mesh(group=None, rank=0, world=1, device=resolve_device(device),
                backend=None)


def make_mesh(n_ranks: int | None = None, device=None) -> Mesh:
    """The mesh over all ranks of the initialized default process group
    (``parallel.launch`` and ``multihost.init_distributed`` initialize it),
    or the mesh of one rank when ``torch.distributed`` is not initialized.

    ``n_ranks``, when given, must equal the world size. ``device`` is this
    rank's device: by default a card, ``cuda:<rank>`` under NCCL and the
    shared ``cuda:0`` otherwise (a missing card raises); pass ``"cpu"``
    for the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_ranks not in (None, 0, 1):
            raise RuntimeError(
                f"make_mesh({n_ranks}): torch.distributed is not initialized "
                "(start the ranks with parallel.launch.run_ranks or torchrun)")
        return single(device)
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise RuntimeError(f"make_mesh({n_ranks}): the process group has "
                           f"{world} ranks")
    backend = dist.get_backend()
    rank = dist.get_rank()
    if world == 1:
        return single(device)
    if device is None and backend == "nccl":
        device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("the NCCL backend needs a CUDA device per rank")
    return Mesh(group=dist.group.WORLD, rank=rank, world=world, device=dev,
                backend=backend)


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """True when the collective on ``t`` goes through a host copy (gloo
    with a tensor on a card; see the module docstring)."""
    return mesh.backend == "gloo" and t.is_cuda


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    if not mesh.distributed:
        return t
    mesh._count("all_reduce", t.numel(), t.element_size())
    buf = t.detach().cpu() if _staged(mesh, t) else t.detach().clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, the same bytes on every rank."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the first axis
    in rank order; a 0-d ``t`` gives a (world,) vector."""
    t = t.reshape(1) if t.dim() == 0 else t
    if not mesh.distributed:
        return t
    mesh._count("all_gather", t.numel() * mesh.world, t.element_size())
    src = (t.detach().cpu() if _staged(mesh, t) else t.detach()).contiguous()
    out = torch.empty((mesh.world * src.shape[0], *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    # the ranks' rows land in consecutive views of the one result
    dist.all_gather(list(out.chunk(mesh.world)), src, group=mesh.group)
    return out.to(t.device)


def all_gather_host(mesh: Mesh, x: np.ndarray) -> np.ndarray:
    """A small host array from every rank, stacked (world, ...); the
    identity (one leading axis added) on a mesh of one rank."""
    x = np.ascontiguousarray(x)
    if not mesh.distributed:
        return x[None]
    t = torch.from_numpy(x.reshape(1, -1))
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    out = all_gather_rows(mesh, t)
    return out.cpu().numpy().reshape((mesh.world, *x.shape))


def broadcast_scalar(mesh: Mesh, value: float) -> float:
    """Rank 0's ``value`` on every rank: time-based decisions are taken on
    rank 0 and handed out, so no two ranks branch differently."""
    if not mesh.distributed:
        return value
    mesh._count("broadcast", 1, 8)
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.broadcast(t, src=0, group=mesh.group)
    return float(t[0])
