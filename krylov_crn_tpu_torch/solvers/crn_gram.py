"""Full-space CRN (CG backend) in Gram space.

Port of ``krylov_crn_tpu/solvers/crn_gram.py``: the reference's large-d
CRN (cubic.py:152-182), secular Newton x CG x SpMV, with rep-space vectors
(ops/gram.py). Each CG matvec is one dense K-matvec, through the SYMV
kernel on a card, and every inner product is closed form.

The JAX structure stays: the secular Newton and the backtracking line
search run on the host, the device does one CG solve per call. The JAX
package's solve is a ``lax.while_loop``; here CG runs in blocks of
``CG_BLOCK`` iterations, each masked by the device flag ``(gamma > tol2) &
(it < maxiter)``, so an iteration past the stop changes no bit, and the
host reads the flag once per block. The iterates and iteration counts
are those of a loop that reads the flag every iteration (the JAX
package's, in fp64). On one card a block is a captured CUDA graph
(``utils/graphs``), replayed until the flag reads done; under a mesh and
on the CPU the blocks run eagerly. ``host_read.count`` counts every
device-to-host read this module makes, ``cg_rep.iterations`` every CG
iteration, ``cg_rep.block_replays`` and ``cg_rep.graph_captures`` the
graphs' replays and captures, so a run can report them per GramCRN
iteration.

fp32 runs pin the committed state to exact fp64 host values after every
iteration and roll back any iteration that raises the exact value
(trust-but-verify); ``metrics["exact_its"]`` / ``["exact_fs"]`` hold the
exact values.

``GramCRN(mesh=)`` runs on a row-banded K like ``GramKrylov``: every CG
matvec is a band product and one all-gather, and the host-sequenced loops
read replicated values, so all ranks take the same branches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from krylov_crn_tpu_torch.config import accum_dtype
from krylov_crn_tpu_torch.ops.gram import (
    GramData,
    Rep,
    _where_rep,
    k_matvec,
    rep_axpy,
    rep_dot,
)
from krylov_crn_tpu_torch.ops.math import (
    fold,
    over_n,
    reg_clamp,
    sigmoid,
    two_sum,
)
from krylov_crn_tpu_torch.ops.symv import symv
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.solvers.krylov_gram import (
    GramKrylov,
    GramKrylovState,
    _candidate_df,
    _fetch,
    _gram_value,
    _x_sqnorm,
)
from krylov_crn_tpu_torch.utils.graphs import StepGraphs

__all__ = ["GramCRN", "gram_crn_step", "cg_rep", "cg_block", "CG_BLOCK",
           "host_read", "watch_rollbacks"]


def host_read(*tensors):
    """Host fp64 values of device tensors through ONE transfer (a single
    tensor gives a float); ``host_read.count`` counts the transfers."""
    host_read.count += 1
    if len(tensors) == 1 and tensors[0].dim() == 0:
        return float(tensors[0])
    return [float(v) if np.ndim(v) == 0 else v for v in _fetch(tensors)]


host_read.count = 0


def _full(v, dtype, device):
    """A 0-d tensor of a host float, rounded to ``dtype`` (a fill kernel,
    no host-to-device copy)."""
    return torch.full((), v, dtype=dtype, device=device)


def _rep_zero(npad, cdt, dev):
    z = torch.zeros(npad, dtype=cdt, device=dev)
    return Rep(torch.zeros((), dtype=cdt, device=dev), z, z)


# CG iterations per host read. A solve of N iterations runs ceil(N / B)
# blocks (one if it starts converged), so it runs fewer than B masked
# iterations past its stop, each a whole CG iteration (1.0 ms of device
# time on rcv1-like, H100), and reads the host ceil(N / B) times instead
# of N + 1. B = 4 costs 1.5 masked iterations a solve on average and cuts
# the reads fourfold.
CG_BLOCK = 4


class CGState(NamedTuple):
    """What a CG solve carries from one iteration to the next."""

    x: Rep
    r: Rep
    p: Rep
    gamma: torch.Tensor  # <r, r> in the accumulation dtype
    it: torch.Tensor  # iterations run (int64)


def _cg_going(st: CGState, tol2, maxiter):
    return (st.gamma > tol2) & (st.it < maxiter)


def _cg_start(gd: GramData, b: Rep, rtol, adt):
    """(tol2, the state before the first iteration): x = 0, r = p = b."""
    bnorm2 = rep_dot(gd, b, b, adt)
    tol2 = (rtol * rtol) * bnorm2
    zero = _rep_zero(b.w.shape[0], b.w.dtype, b.w.device)
    it = torch.zeros((), dtype=torch.int64, device=b.w.device)
    return tol2, CGState(zero, b, b, bnorm2, it)


def cg_block(gd: GramData, matvec, st: CGState, tol2, maxiter, adt,
             block: int) -> CGState:
    """``block`` CG iterations, each masked by ``_cg_going``: where the
    solve has stopped, x, r, p, gamma and it keep their bits. No host
    read."""
    cdt = st.r.w.dtype
    for _ in range(block):
        x, r, p, gamma, it = st
        going = _cg_going(st, tol2, maxiter)
        Ap = matvec(p)
        alpha = (gamma / rep_dot(gd, p, Ap, adt)).to(cdt)
        x_n = rep_axpy(x, alpha, p)
        r_n = rep_axpy(r, -alpha, Ap)
        gamma_n = rep_dot(gd, r_n, r_n, adt)
        beta = (gamma_n / gamma).to(cdt)
        p_n = Rep(r_n.beta + beta * p.beta, r_n.w + beta * p.w,
                  r_n.u + beta * p.u)
        st = CGState(_where_rep(going, x_n, x), _where_rep(going, r_n, r),
                     _where_rep(going, p_n, p),
                     torch.where(going, gamma_n, gamma),
                     it + going.to(it.dtype))
    return st


def _cg_blocks(run_block, st: CGState, tol2, maxiter):
    """Blocks until the flag reads done, one host read per block (the flag
    and the iteration count in one transfer). Returns (x, its)."""
    while True:
        st = run_block(st)
        going, its = host_read(_cg_going(st, tol2, maxiter), st.it)
        if not going:
            break
    its = int(its)
    cg_rep.iterations += its
    return st.x, its


def cg_rep(gd: GramData, matvec, b: Rep, rtol, maxiter, adt):
    """CG over rep-space vectors; the JAX package's ``cg_rep`` in eager
    blocks of ``CG_BLOCK`` masked iterations, one host read per block.
    Returns (x, its)."""
    tol2, st = _cg_start(gd, b, rtol, adt)
    block = CG_BLOCK
    return _cg_blocks(lambda s: cg_block(gd, matvec, s, tol2, maxiter, adt,
                                         block), st, tol2, maxiter)


cg_rep.iterations = 0
cg_rep.block_replays = 0
cg_rep.graph_captures = 0


class _CGBuffers(NamedTuple):
    """A CG block's static buffers: the operator's D and shift, tol2, and
    the carried state, flat."""

    D: torch.Tensor
    lam: torch.Tensor
    tol2: torch.Tensor
    xb: torch.Tensor
    xw: torch.Tensor
    xu: torch.Tensor
    rb: torch.Tensor
    rw: torch.Tensor
    ru: torch.Tensor
    pb: torch.Tensor
    pw: torch.Tensor
    pu: torch.Tensor
    gamma: torch.Tensor
    it: torch.Tensor


def _flat(st: CGState):
    return (*st.x, *st.r, *st.p, st.gamma, st.it)


def _unflat(bufs: _CGBuffers) -> CGState:
    return CGState(Rep(bufs.xb, bufs.xw, bufs.xu),
                   Rep(bufs.rb, bufs.rw, bufs.ru),
                   Rep(bufs.pb, bufs.pw, bufs.pu), bufs.gamma, bufs.it)


class _CGGraphs(StepGraphs):
    """A block of ``CG_BLOCK`` CG iterations on (H + lam I) captured as a
    CUDA graph, for one GramCRN on one card. The block runs over static
    buffers (D, the shifted lam, tol2, x, r, p, gamma, it); a solve is the
    start state loaded, then replays until the flag reads done. Graphs
    are keyed on the GramData (K's address), l2, the dtypes, the block
    and maxiter; a new GramData drops them."""

    def __init__(self, device):
        super().__init__(device, ((symv, "launches"),
                                  (k_matvec, "cuda_calls"),
                                  (fold, "launches")),
                         (cg_rep, "graph_captures"),
                         (cg_rep, "block_replays"))
        self.gd = None

    def solve(self, gd: GramData, D, rhs: Rep, lam_c, l2, rtol, maxiter,
              adt):
        """CG on (H + lam_c I) s = rhs; returns (s, its) as ``cg_rep``."""
        if self.gd is not gd:
            self.graphs.clear()
            self.gd = gd
        tol2, st = _cg_start(gd, rhs, rtol, adt)
        start = _CGBuffers(D, lam_c, tol2, *_flat(st))
        self.buffers(start)
        self.load(start)
        block = CG_BLOCK
        key = (gd.K.data_ptr(), float(l2), rhs.w.dtype, adt, block,
               int(maxiter))
        entry = self.graphs.get(key)
        if entry is None:
            def run(bufs):
                hop = _hop(gd, bufs.D, l2)
                return cg_block(gd, lambda v: rep_axpy(hop(v), bufs.lam, v),
                                _unflat(bufs), bufs.tol2, maxiter, adt, block)

            def body():
                for dst, src in zip(self.state[3:], _flat(run(self.state))):
                    dst.copy_(src)

            entry = self.capture(key, body, lambda: run(self.clone()))

        def replay(_):
            self.replay(entry)
            return _unflat(self.state)

        x, its = _cg_blocks(replay, st, self.state.tol2, maxiter)
        return Rep(*(t.clone() for t in x)), its


def _grad_probe(gd: GramData, state: GramKrylovState, l2, adt):
    """Gradient rep g, ||g||, Hessian weights D — one K-matvec, on the
    step-sized dw of the incremental (w_g, uK) invariant. Returns the
    refreshed (w_new, uK) for the caller to commit."""
    n = gd.n
    sig0 = sigmoid(state.Ax)
    sig = sig0 + sig0 * (1.0 - sig0) * state.Ax_lo
    residual = (sig - gd.b) * gd.mask
    w_new = over_n(residual, n) + (l2 * state.zeta if l2 else 0.0)
    dw = w_new - state.w_g
    uK = state.uK + k_matvec(gd.K, dw, gd.mesh)
    beta_g = l2 * state.gamma
    u_g = beta_g * gd.Ax0 + uK
    g = Rep(beta_g, w_new, u_g)
    g_norm = torch.sqrt(torch.clamp(rep_dot(gd, g, g, adt), min=0.0))
    D = over_n(sig0 * (1.0 - sig0) * gd.mask, n)
    return g, g_norm, D, w_new, uK


def _hop(gd: GramData, D, l2):
    """H v in rep space: one K-matvec (the l2 terms only when l2 > 0)."""
    def hop(v: Rep) -> Rep:
        q = D * v.u
        if not l2:
            return Rep(0.0 * v.beta, q, k_matvec(gd.K, q, gd.mesh))
        return Rep(l2 * v.beta, q + l2 * v.w,
                   k_matvec(gd.K, q, gd.mesh) + l2 * v.u)

    return hop


def _cg_shifted(gd: GramData, D, rhs: Rep, lam, l2, solver_eps, cg_maxiter,
                adt, graphs=None):
    """Solve (H + lam I) s = rhs by CG, through the replayed blocks of
    ``graphs`` (a ``_CGGraphs``) where given. Returns (s, <s, s>,
    iterations)."""
    cdt = rhs.w.dtype
    # lam rounds to the accumulation dtype, then to the storage dtype
    lam_c = _full(lam, adt, rhs.w.device).to(cdt)
    if graphs is not None:
        s, it = graphs.solve(gd, D, rhs, lam_c, l2, solver_eps, cg_maxiter,
                             adt)
    else:
        hop = _hop(gd, D, l2)
        s, it = cg_rep(gd, lambda v: rep_axpy(hop(v), lam_c, v), rhs,
                       solver_eps, cg_maxiter, adt)
    return s, rep_dot(gd, s, s, adt), it


def _trial_eval(gd: GramData, state: GramKrylovState, g: Rep, s: Rep,
                lam, reg, l2, adt):
    """Candidate state pieces and model decrease for one line-search
    trial (``lam``, ``reg``: 0-d tensors of the accumulation dtype). For
    l2 == 0 the loss change is evaluated in difference form, so the accept
    decision carries error proportional to the decrease; l2 > 0 keeps the
    absolute path (the l2 term needs |x|^2). Returns (..., dfh, dfl), the
    change pair."""
    s2 = rep_dot(gd, s, s, adt)
    norm_s = torch.sqrt(torch.clamp(s2, min=0.0))
    model_dec = (lam / 2.0 * s2 - reg / 3.0 * norm_s ** 3
                 - rep_dot(gd, g, s, adt) / 2.0)
    gamma_new = state.gamma + s.beta
    zeta_new = state.zeta + s.w
    Ax_new, e = two_sum(state.Ax, s.u)
    Ax_lo_new = state.Ax_lo + e
    if l2:
        xsq = _x_sqnorm(gd, gamma_new, zeta_new, Ax_new, adt,
                        Ax_lo=Ax_lo_new)
        vhi, vlo = _gram_value(gd, Ax_new, xsq, l2, adt, Ax_lo=Ax_lo_new)
        dfh, err = two_sum(vhi, -state.value)
        dfl = err + (vlo - state.value_lo)
    else:
        dfh, dfl = _candidate_df(gd, state.Ax, s.u, adt)
        vhi, err = two_sum(state.value, dfh)
        vlo = state.value_lo + err + dfl
    return (gamma_new, zeta_new, Ax_new, Ax_lo_new, vhi, vlo, model_dec,
            norm_s, dfh, dfl)


def _ls_accept_host(dfh, dfl, fhi, model_dec, cdt):
    """Difference-form accept test on host floats: the change pair sums
    exactly in fp64; once the model decrease is below one ulp of f, any
    non-increase up to that ulp is accepted."""
    gap = dfh + dfl
    ulp = float(torch.finfo(cdt).eps) * abs(fhi)
    if not np.isfinite(gap):
        return False
    return (gap <= -model_dec) or (model_dec <= ulp and gap <= ulp)


def gram_crn_step(
    gd: GramData,
    state: GramKrylovState,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    tolerance: float = 0.0,
    ls_max: int = 200,
    cg_maxiter: int = 500,
    accum_dtype=None,
    reg_ceil: float = 1e6,
    cg_graphs=None,
) -> GramKrylovState:
    """One CRN-CG iteration: host-sequenced secular Newton and
    backtracking line search over one-CG-solve device calls (reference
    cubic.py:152-182 and 190-226). ``cg_graphs`` (a ``_CGGraphs``, one
    card): every CG solve replays its captured blocks."""
    cdt = state.zeta.dtype
    adt = cdt if accum_dtype is None else accum_dtype
    dev = state.zeta.device
    l2 = float(l2)

    g, g_norm_dev, D, w_new, uK_new = _grad_probe(gd, state, l2, adt)
    state = state._replace(w_g=w_new, uK=uK_new)
    g_norm, r0, reg_coef, fhi, fb_hi, fb_lo = host_read(
        g_norm_dev, state.r0, state.reg_coef, state.value, state.f_best,
        state.f_best_lo)
    grad_norm = g_norm_dev.to(cdt)

    if tolerance > 0.0 and g_norm < tolerance:
        return state._replace(diff_norm=torch.zeros_like(state.diff_norm),
                              grad_norm=grad_norm)

    neg_g = Rep(-g.beta, -g.w, -g.u)

    def solve(lam):
        return _cg_shifted(gd, D, neg_g, lam, l2, solver_eps, cg_maxiter,
                           adt, cg_graphs)

    def newton(reg):
        """Safeguarded 1-D Newton on phi(lam) = lam^2 - reg^2 ||s(lam)||^2
        with s(lam) = -(H + lam I)^{-1} g; two CG solves per iteration (s,
        and the derivative term), like the reference's func/fprime pair
        (cubic.py:157-171). lam is clamped at 0 only: logistic Hessians
        are PSD, and CG needs H + lam I positive definite anyway."""
        lam = r0
        it = 0
        while it < solver_it_max:
            s, s2_dev, _ = solve(lam)
            hinv_s, _, _ = _cg_shifted(gd, D, s, lam, l2, solver_eps,
                                       cg_maxiter, adt, cg_graphs)
            s2, sh = host_read(s2_dev, rep_dot(gd, s, hinv_s, adt))
            phi = lam * lam - reg * reg * s2
            dphi = 2.0 * lam + 2.0 * reg * reg * sh
            step = phi / dphi
            lam = max(lam - step, 0.0)
            it += 1
            if abs(step) < solver_eps:
                break
        return lam, it

    reg = reg_coef * beta  # optimistic decrease first
    trials = 0
    accepted = False
    while True:
        lam, newton_it = newton(reg)
        s, _, _ = solve(lam)
        (gamma_new, zeta_new, Ax_new, Ax_lo_new, vhi, vlo, model_dec,
         norm_s, dfh, dfl) = _trial_eval(gd, state, g, s,
                                         _full(lam, adt, dev),
                                         _full(reg, adt, dev), l2, adt)
        dfh_h, dfl_h, md_h, vhi_h, vlo_h = host_read(dfh, dfl, model_dec,
                                                     vhi, vlo)
        if _ls_accept_host(dfh_h, dfl_h, fhi, md_h, cdt):
            accepted = True
            break
        if trials >= ls_max:
            break
        reg /= beta
        trials += 1

    solver_it = state.solver_it + newton_it
    if not accepted:
        # All-reject episode (reachable only through fp32 trial noise near
        # the numerical floor): freeze the iterate, raise reg one notch and
        # report diff_norm = inf, not a tolerance convergence. Committing
        # the last trial instead was seen to diverge the JAX package's fp32
        # runs.
        return state._replace(
            reg_coef=reg_clamp(state.reg_coef.to(adt) / beta,
                               reg_ceil).to(cdt),
            r0=_full(lam, cdt, dev), solver_it=solver_it,
            diff_norm=torch.full_like(state.diff_norm, float("inf")),
            grad_norm=grad_norm)

    value_new, value_new_lo = vhi.to(cdt), vlo.to(cdt)
    better = vhi_h + vlo_h < fb_hi + fb_lo
    return GramKrylovState(
        gamma=gamma_new, zeta=zeta_new, Ax=Ax_new, Ax_lo=Ax_lo_new,
        w_g=state.w_g, uK=state.uK,
        value=value_new, value_lo=value_new_lo,
        reg_coef=reg_clamp(_full(reg, cdt, dev), reg_ceil),
        r0=_full(lam, cdt, dev), solver_it=solver_it,
        diff_norm=norm_s.to(cdt), grad_norm=grad_norm,
        f_best=value_new if better else state.f_best,
        f_best_lo=value_new_lo if better else state.f_best_lo,
    )


class GramCRN(GramKrylov):
    """Reference ``Cubic_LS`` with cubic_solver="CG", in Gram space, on
    ``device``. ``metrics["cg_its"]``, ``["cg_replays"]`` and
    ``["host_reads"]`` record each iteration's CG iterations, CG block
    replays (one card) and host reads."""

    def __init__(self, reg_coef=None, solver_it_max=100, solver_eps=1e-8,
                 beta=0.5, cg_maxiter=500, ls_max=200, **kwargs):
        super().__init__(reg_coef=reg_coef, solver_eps=solver_eps,
                         beta=beta, solver_it_max=solver_it_max,
                         ls_max=ls_max, **kwargs)
        self.cg_maxiter = int(cg_maxiter)
        self._crn_verified = None
        self._cg_graphs: _CGGraphs | None = None

    def init_run(self, x0, seed):
        super().init_run(x0, seed)
        # each run seeds its own trust-but-verify baseline (step())
        self._crn_verified = None

    def _cg_block_graphs(self):
        """The instance's CG block graphs on one card, else None: the CPU
        runs the blocks eagerly, and gloo's collectives cannot be
        captured (under a mesh every rank reads the same replicated flag,
        so all take the same branches)."""
        if self.mesh is not None or not self.state.zeta.is_cuda:
            return None
        if self._cg_graphs is None:
            self._cg_graphs = _CGGraphs(self.state.zeta.device)
        return self._cg_graphs

    def step(self):
        fp32 = self.state.zeta.dtype == torch.float32
        n = self.loss.A_host.shape[0]
        if fp32 and self._crn_verified is None:
            # seed trust-but-verify from the exact initial state (init_state
            # computes its value in host fp64 and the rep is gamma=1,
            # zeta=0), so a first-step explosion cannot become the baseline
            gamma0, vhi0, vlo0 = host_read(self.state.gamma,
                                           self.state.value,
                                           self.state.value_lo)
            self._crn_verified = dict(gamma=gamma0, zeta=np.zeros(n),
                                      f=vhi0 + vlo0)
        reads0, cg0 = host_read.count, cg_rep.iterations
        replays0 = cg_rep.block_replays
        self.state = gram_crn_step(
            self.gd, self.state,
            l2=self.loss.l2, beta=self.beta, solver_eps=self.solver_eps,
            solver_it_max=self.solver_it_max,
            tolerance=float(self.tolerance), ls_max=self.ls_max,
            cg_maxiter=self.cg_maxiter,
            accum_dtype=accum_dtype(self.state.zeta.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
            cg_graphs=self._cg_block_graphs(),
        )
        m = self.trace.metrics
        if fp32:
            # pin the committed state to exact fp64 host values every
            # iteration (two sparse SpMVs on the host); without this the
            # incremental fp32 margins floor the reachable gap near 1e-5
            self._ensure_exact_setup()
            st = self.state
            gamma_h, reg_h, r0_h, sit_h, zeta = host_read(
                st.gamma, st.reg_coef, st.r0, st.solver_it, st.zeta)
            zeta_h = np.asarray(zeta, np.float64)[:n]
            v64 = self._exact_reinject(gamma_h, zeta_h)
            # trust-but-verify: near the fp32 floor a CG step on a
            # near-singular H + lam I can pass the accept test on noise and
            # raise the exact f; such an iteration rolls back to the last
            # verified iterate with reg one notch up
            prev = self._crn_verified
            if prev is not None and v64 > prev["f"]:
                m.setdefault("rollback_its", []).append(self.it + 1)
                m.setdefault("rollback_fs", []).append(v64)
                self._exact_reinject(
                    prev["gamma"], prev["zeta"],
                    reg=min(reg_h / self.beta,
                            max(1e6, 1e4 * float(self.reg_coef))),
                    r0=r0_h, solver_it=int(sit_h))
                v64 = prev["f"]
            else:
                self._crn_verified = dict(gamma=gamma_h, zeta=zeta_h.copy(),
                                          f=v64)
            m.setdefault("exact_its", []).append(self.it + 1)
            m.setdefault("exact_fs", []).append(v64)
        m.setdefault("cg_its", []).append(cg_rep.iterations - cg0)
        m.setdefault("cg_replays", []).append(cg_rep.block_replays
                                              - replays0)
        m.setdefault("host_reads", []).append(host_read.count - reads0)

    def check_convergence(self):
        if (self.tolerance > 0 and self.it > 0
                and float(self.state.grad_norm) < self.tolerance):
            return True
        return Optimizer.check_convergence(self)


def _host(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def watch_rollbacks(alg):
    """A check of ``alg``'s trust-but-verify rollback, for tests and the
    card's smoke run; ``alg`` is this module's GramCRN or the JAX
    package's (both restore through ``_exact_reinject``). Before each
    rollback it records the verified snapshot (gamma, zeta) and the reg
    the rule restores (the rejected iteration's reg one notch up, capped);
    after each step that rolled back, whether the state holds exactly
    those bits, and the state itself. Returns the list of records."""
    checks = []
    reinject, step = alg._exact_reinject, alg.step

    def watched_reinject(gamma, zeta64, reg=None, **kw):
        if reg is not None:
            prev = alg._crn_verified
            checks.append(dict(gamma=prev["gamma"], zeta=prev["zeta"].copy(),
                               reg=min(float(alg.state.reg_coef) / alg.beta,
                                       max(1e6, 1e4 * float(alg.reg_coef))),
                               reg_given=reg))
        return reinject(gamma, zeta64, reg=reg, **kw)

    def watched_step():
        before = len(checks)
        step()
        if len(checks) > before:
            c, st = checks[-1], alg.state
            n = c["zeta"].shape[0]
            z = _host(st.zeta)
            c["state"] = dict(gamma=float(st.gamma), zeta=z[:n].copy(),
                              reg=float(st.reg_coef))
            c["restored"] = bool(
                float(st.gamma) == np.float32(c["gamma"])
                and np.array_equal(z[:n], c["zeta"].astype(np.float32))
                and not z[n:].any()
                and float(st.reg_coef) == np.float32(c["reg"])
                and c["reg_given"] == c["reg"])

    alg._exact_reinject, alg.step = watched_reinject, watched_step
    return checks
