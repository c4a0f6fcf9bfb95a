"""Carry the JAX package's data and solver states across to the port.

Each function takes an object whose leaves are numpy arrays — a
``krylov_crn_tpu`` ``GramData``, ``GramKrylovState``, ``KrylovState`` or
``CRNState`` after ``jax.device_get`` — and returns the port's
counterpart as tensors on ``device``. With them a test runs the same step
from the same state on both sides. This module does not import jax; it
reads attributes only.
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_crn_tpu_torch.config import resolve_device
from krylov_crn_tpu_torch.ops.gram import GramData
from krylov_crn_tpu_torch.solvers.crn import CRNState
from krylov_crn_tpu_torch.solvers.krylov_crn import KrylovState
from krylov_crn_tpu_torch.solvers.krylov_gram import GramKrylovState

__all__ = ["gram_data_from_numpy", "state_from_numpy",
           "krylov_state_from_numpy", "crn_state_from_numpy"]


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def gram_data_from_numpy(gd, device=None) -> GramData:
    """The port's GramData from the leaves of a JAX ``GramData`` (K, Ax0,
    b, mask, x0_sqnorm, n, d, nnz; its bf16 copy K_lr is not carried)."""
    dev = resolve_device(device)
    return GramData(
        K=_tensor(gd.K, dev), Ax0=_tensor(gd.Ax0, dev), b=_tensor(gd.b, dev),
        mask=_tensor(gd.mask, dev), x0_sqnorm=_tensor(gd.x0_sqnorm, dev),
        n=int(gd.n), d=int(gd.d), nnz=int(gd.nnz))


def _state(cls, st, device):
    dev = resolve_device(device)
    fields = {f: _tensor(getattr(st, f), dev) for f in cls._fields}
    fields["solver_it"] = fields["solver_it"].to(torch.int64)
    return cls(**fields)


def state_from_numpy(st, device=None) -> GramKrylovState:
    """The port's GramKrylovState from the leaves of a JAX
    ``GramKrylovState`` (same field names; solver_it becomes int64)."""
    return _state(GramKrylovState, st, device)


def krylov_state_from_numpy(st, device=None) -> KrylovState:
    """The port's d-space KrylovState from a JAX ``KrylovState``."""
    return _state(KrylovState, st, device)


def crn_state_from_numpy(st, device=None) -> CRNState:
    """The port's CRNState from a JAX ``CRNState``."""
    return _state(CRNState, st, device)
