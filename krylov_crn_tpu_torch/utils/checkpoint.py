"""Solver-state checkpoint / resume.

Port of ``krylov_crn_tpu/utils/checkpoint.py``. The reference only pickles
traces; here the whole solver state (iterate or Gram rep, margins,
reg_coef, warm-started secular root, ...) plus the run counters and trace
arrays round-trip through one ``.npz`` file, so a run continues exactly
where it stopped. States are NamedTuples of tensors, stored by field name
and loaded back onto the device of the state they replace. SSCN's
coordinate generator (a CPU ``torch.Generator``) is saved with its run, so
a resumed run draws the same coordinates as an unbroken one.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_state", "load_state", "save_run", "load_run"]

_EXTRA = "__extra__"
_GENERATOR = "__generator__"


def _host(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_state(path, state, extra: dict | None = None,
               arrays: dict | None = None) -> None:
    """Write a NamedTuple state of tensors (by field name), JSON extras and
    optional named host arrays to ``path`` (.npz)."""
    out = {f"state.{f}": _host(getattr(state, f)) for f in state._fields}
    for k, v in (arrays or {}).items():
        out[k] = np.asarray(v)
    out[_EXTRA] = np.frombuffer(json.dumps(extra or {}).encode(), np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with io.BytesIO() as buf:
        np.savez(buf, **out)
        path.write_bytes(buf.getvalue())


def _load(path, like_state):
    with np.load(Path(path), allow_pickle=False) as z:
        extra = json.loads(bytes(z[_EXTRA].tobytes()).decode())
        fields = {}
        for f in like_state._fields:
            like = getattr(like_state, f)
            fields[f] = torch.from_numpy(np.array(z[f"state.{f}"])).to(
                device=like.device, dtype=like.dtype)
        arrays = {k: np.array(z[k]) for k in z.files
                  if not k.startswith("state.") and k != _EXTRA}
    return type(like_state)(**fields), extra, arrays


def load_state(path, like_state):
    """Read a state written by ``save_state`` back into ``like_state``'s
    type, dtypes and device. Returns (state, extra_dict)."""
    state, extra, _ = _load(path, like_state)
    return state, extra


def save_run(path, optimizer) -> None:
    """Checkpoint an Optimizer mid-run: state, counters, trace series and,
    for SSCN, the coordinate generator's state."""
    trace = optimizer.trace
    extra = {
        "it": optimizer.it,
        "t": optimizer.t,
        "its": [int(i) for i in trace.its],
        "ts": [float(t) for t in trace.ts],
        "loss_vals": [float(v) for v in np.asarray(trace.loss_vals).ravel()]
        if len(trace.loss_vals) else [],
        "solver_its": ([int(s) for s in trace.solver_its]
                       if trace.solver_its else None),
        "max_progress": optimizer.max_progress,
        "label": optimizer.label,
    }
    arrays = {}
    gen = getattr(optimizer, "generator", None)
    if gen is not None:
        arrays[_GENERATOR] = gen.get_state().numpy()
    save_state(path, optimizer.state, extra, arrays)


def load_run(path, optimizer) -> None:
    """Restore a checkpoint written by ``save_run`` into an initialized
    Optimizer (call after ``init_run`` with the same x0 and config)."""
    state, extra, arrays = _load(path, optimizer.state)
    optimizer.state = state
    optimizer.it = extra["it"]
    optimizer.t = extra["t"]
    optimizer.max_progress = extra.get("max_progress", 0)
    optimizer.trace.its = list(extra["its"])
    optimizer.trace.ts = list(extra["ts"])
    if extra["loss_vals"]:
        optimizer.trace.loss_vals = list(extra["loss_vals"])
    if extra["solver_its"] is not None:
        optimizer.trace.solver_its = list(extra["solver_its"])
    if _GENERATOR in arrays:
        optimizer.generator.set_state(torch.from_numpy(arrays[_GENERATOR]))
