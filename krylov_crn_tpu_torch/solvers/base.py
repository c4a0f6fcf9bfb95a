"""Optimizer run-loop engine.

Port of ``krylov_crn_tpu/solvers/base.py`` (the reference's Optimizer,
optimizer.py:17-172): multi-seed runs, wall-clock / iteration /
iterate-diff convergence, trace subsampling that keeps the first
``save_first_iterations`` checkpoints then thins by progress fraction, and
post-run loss evaluation. ``step()`` runs one solver step on the device;
the host loop reads back scalars only for convergence and tracing.

``store_iterates=False`` keeps the loss values (read from the state's
two-float value pair) instead of the iterates; ``warm`` runs one throwaway
step so one-time costs (kernel builds, cuSOLVER/cuBLAS handles) land
outside a timed ``run``. The JAX package's tqdm progress bar is left out.

Under a mesh of several ranks (``self.mesh``, taken from a sharded oracle
or given to the Gram solvers) every rank runs this loop and must take the
same branches. Iteration counts and tolerances read replicated values;
the clock does not, so a run with a finite ``t_max`` uses rank 0's
elapsed time on every rank (``elapsed``). After every step the ranks
compare a hash of the replicated state (``check_replicated``): state whose
bits drifted apart raises on every rank instead of hanging.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from krylov_crn_tpu_torch.parallel.mesh import (
    broadcast_scalar,
    check_replicated,
)
from krylov_crn_tpu_torch.utils.spans import span
from krylov_crn_tpu_torch.utils.trace import Trace

__all__ = ["Optimizer"]


class Optimizer:
    # state fields that hold this rank's rows only under a mesh (the
    # d-space margins); every other field is replicated
    local_fields = ("Ax",)

    def __init__(self, loss, trace_len=200, tolerance=0,
                 save_first_iterations=5, label=None, seeds=None,
                 store_iterates=True):
        self.loss = loss
        self.trace_len = trace_len
        self.tolerance = tolerance
        self.save_first_iterations = save_first_iterations
        self.label = label
        self.store_iterates = store_iterates
        self.mesh = getattr(loss, "mesh", None)
        self.t_max = np.inf

        self.initialized = False
        self.trace = Trace(loss=loss, label=label)
        self.seeds = [42] if seeds is None else seeds
        self.finished_seeds = []
        self.state: Any = None

    # -- subclass hooks -------------------------------------------------
    def init_state(self, x0, seed):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- engine ---------------------------------------------------------
    def run(self, x0, t_max=np.inf, it_max=np.inf):
        if t_max is np.inf and it_max is np.inf:
            it_max = 100
            print(f"{self.label}: The number of iterations is set to "
                  f"{it_max}.")
        self.t_max = t_max
        self.it_max = it_max

        for seed in self.seeds:
            if seed in self.finished_seeds:
                continue
            if len(self.seeds) > 1:
                print(f"{self.label}: Running seed {seed}")
            self.rng = np.random.default_rng(seed)
            if not self.initialized:
                self.init_run(x0, seed)
                self.initialized = True
            while not self.check_convergence():
                self.step()
                self.check_replicated(f"after iteration {self.it + 1}")
                self.save_checkpoint()
            self.finished_seeds.append(seed)
            self.initialized = False
            # fold the run's best value into the oracle's empirical-f*
            # record
            f_best = self.best_value()
            if f_best is not None and f_best < self.loss.f_opt:
                self.loss.f_opt = f_best
                self.loss.x_opt = self.current_x()
        return self.trace

    def best_value(self):
        """The run's best value for the empirical f*: the device-tracked
        running best (two-float states: full pair precision), or None."""
        if not hasattr(self.state, "f_best"):
            return None
        return (float(self.state.f_best)
                + float(getattr(self.state, "f_best_lo", 0.0)))

    def warm(self, x0, seed=42):
        """One throwaway step from a fresh start, so the step's one-time
        costs land outside a later timed ``run``, which re-initializes
        from scratch. Trace metrics the step writes (GramCRN's exact-value
        stream) are restored, so the throwaway iteration does not leak
        into the real run."""
        self.rng = np.random.default_rng(seed)
        self.init_run(x0, seed)
        saved_metrics = {k: list(v) for k, v in self.trace.metrics.items()}
        self.step()
        st = self.state
        float(getattr(st, "value", getattr(st, "grad_norm", 0.0)))
        self.trace.metrics = saved_metrics
        self.initialized = False

    def check_replicated(self, where: str) -> None:
        """Under a mesh of several ranks: every rank holds the same bits in
        each replicated state field, or every rank raises."""
        if self.mesh is None or not self.mesh.distributed:
            return
        st = self.state
        check_replicated(self.mesh, where, **{
            k: getattr(st, k) for k in st._fields
            if k not in self.local_fields})

    def current_x(self):
        """The current iterate as an explicit vector (or None); the Gram
        solver overrides this to materialize its (gamma, zeta) rep."""
        return getattr(self.state, "x", None)

    def elapsed(self):
        """Seconds since the run's start; with several ranks and a finite
        ``t_max``, rank 0's reading on every rank (the time stop and the
        trace thinning branch on it)."""
        t = time.perf_counter() - self.t_start
        if (self.mesh is not None and self.mesh.distributed
                and np.isfinite(self.t_max)):
            t = broadcast_scalar(self.mesh, t)
        return t

    def check_convergence(self):
        no_it_left = self.it >= self.it_max
        no_time_left = self.elapsed() >= self.t_max
        tolerance_met = False
        if self.tolerance > 0 and self.it > 0:
            tolerance_met = float(self.state.diff_norm) < self.tolerance
        return no_it_left or no_time_left or tolerance_met

    def init_run(self, x0, seed):
        x0 = np.asarray(x0)
        self.dim = x0.shape[0]
        self.state = self.init_state(x0, seed)
        self.trace.xs = [x0] if self.store_iterates else []
        self.trace.its = [0]
        self.trace.ts = [0]
        if not self.store_iterates:
            self.trace.loss_vals = [float(self.loss.value(x0))]
        self.it = 0
        self.t = 0
        self.t_start = time.perf_counter()
        self.time_progress = 0
        self.iterations_progress = 0
        self.max_progress = 0

    def should_update_trace(self):
        if self.it <= self.save_first_iterations:
            return True
        span = self.trace_len - self.save_first_iterations
        self.time_progress = int(span * self.t / self.t_max)
        self.iterations_progress = int(span * (self.it / self.it_max))
        return max(self.time_progress, self.iterations_progress) > \
            self.max_progress

    def save_checkpoint(self):
        with span("run.checkpoint"):
            self.it += 1
            self.t = self.elapsed()
            if self.should_update_trace():
                self.update_trace()
            self.max_progress = max(self.time_progress,
                                    self.iterations_progress)

    def update_trace(self):
        if self.store_iterates:
            self.trace.xs.append(self.state.x)
        else:
            self.trace.loss_vals = list(self.trace.loss_vals)
            self.trace.loss_vals.append(
                float(self.state.value)
                + float(getattr(self.state, "value_lo", 0.0)))
        self.trace.ts.append(self.t)
        self.trace.its.append(self.it)

    def compute_loss_of_iterates(self):
        self.loss.reset()
        self.trace.compute_loss_of_iterates()

    def reset(self, loss):
        self.initialized = False
        self.trace = Trace(loss=loss, label=self.label)
        self.finished_seeds = []
        self.state = None
