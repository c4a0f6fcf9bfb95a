"""Krylov CRN in Gram space — the port's main path.

Port of ``krylov_crn_tpu/solvers/krylov_gram.py``: the same algorithm
(reference cubic.py:238-319) on dense n x n K-matvecs instead of sparse
gathers. The iterate never materializes: the state carries (gamma, zeta,
margins) with x = gamma*x0 + A^T zeta. Per iteration: m + 1 K-matvecs
through the SYMV kernel, O(m n) vector work, and the secular line search
over all 21 candidate regularizations at once.

fp32 runs carry margins and values as two-float pairs and get their
margins, gradient image and value re-evaluated exactly in fp64 on the
host at every chunk boundary (``run_fused``); a chunk that does not
improve the exact value is rolled back (trust-but-verify).

Between chunk boundaries a card runs without the host, as the JAX
package's ``lax.scan`` under ``jit`` does: the subproblem of a step (the
tridiagonal eigh and the candidates' secular Newton) is one launch of the
kernel ``csrc/subproblem.cu`` with no host read, and on one card
``run_fused`` replays the step captured as a CUDA graph
(``GramKrylov.warm_fused`` captures ahead of a timed run). As the JAX
package compiles a chunk program once per process, the process keeps a
card's step graphs by the step's shape (``_GraphCache``), and a later
solver of that shape replays them on its own K, which their SYMVs read at
an address kept on the card (``ops/symv.KSlot``).

Under a mesh (``GramKrylov(mesh=)``) K is row-banded over the ranks and
every state vector is replicated: each rank runs the same step on the
same bytes, and the only collectives of a step are the m + 1 all-gathers
of its K-matvecs (``ops/gram.k_matvec``). The JAX package's ``repl``
sharding pins and ``_dev_like`` are GSPMD plumbing with no counterpart:
replicated tensors simply live on each rank. Every rank keeps the host
scipy matrix and does the exact fp64 reinjection and certification
itself, on identical inputs.

``GramKrylov(bf16_head=True)`` (default off, as in the JAX package) runs
the Lanczos matvecs on the bf16 copy of K (``GramData.K_lr``) until the
gradient norm has fallen below ``fp32_tail_rtol`` times its first
reading, then on the fp32 K: a step of the head runs the m Lanczos
products through the bf16 path of the matvec kernel on a card
(``_lr_matvec``), and refreshes the basis images through the fp32 K in
one (m, n_pad) x (n_pad, n_pad) product.

Left out against the JAX package: margin re-derivation (``run_fused``
passes ``rederive=False``; it is the JAX step's (m+2)-th K-matvec) and
the relay-link warm-ups.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import expit

from krylov_crn_tpu_torch.config import accum_dtype, resolve_device
from krylov_crn_tpu_torch.ops.gram import (
    GramData,
    Rep,
    build_gram,
    gram_lanczos,
    k_matvec,
    pad_rows,
    rep_dot,
)
from krylov_crn_tpu_torch.ops.math import (
    accum_sum_pair,
    over_n,
    dot2,
    fold,
    logsig,
    pair_diff,
    reg_clamp,
    sigmoid,
    softplus,
    two_sum,
)
from krylov_crn_tpu_torch.ops.matvec import matvec
from krylov_crn_tpu_torch.ops.subproblem import tridiag_secular
from krylov_crn_tpu_torch.ops.symv import KSlot, symv
from krylov_crn_tpu_torch.parallel.mesh import all_gather_rows, check_replicated
from krylov_crn_tpu_torch.solvers.base import Optimizer
from krylov_crn_tpu_torch.utils.graphs import StepGraphs
from krylov_crn_tpu_torch.utils.spans import span

__all__ = ["GramKrylov", "GramKrylovState", "gram_krylov_step",
           "gram_krylov_multistep"]


class GramKrylovState(NamedTuple):
    """Committed Gram-space iterate plus the fp32 numerics state.

    Margins are a two-float pair (Ax, Ax_lo) updated with error-free
    two-sums, so they track the exact margins to about twice fp32
    precision between host corrections. (w_g, uK) keep the gradient image
    incrementally, uK == K @ w_g: the fresh matvec then runs on the
    step-sized difference of weights, so its rounding shrinks with
    convergence instead of drowning the tail gradient. In fp64 runs the
    pairs carry lo = 0."""

    gamma: torch.Tensor  # coefficient of x0 in x = gamma*x0 + A^T zeta
    zeta: torch.Tensor  # (n_pad,)
    Ax: torch.Tensor  # margins hi (n_pad,), invariant: gamma*Ax0 + K zeta
    Ax_lo: torch.Tensor  # margins lo
    w_g: torch.Tensor  # (n_pad,) weight vector of the last gradient image
    uK: torch.Tensor  # (n_pad,) == K @ w_g, maintained incrementally
    value: torch.Tensor  # f(x) two-float hi part
    value_lo: torch.Tensor
    reg_coef: torch.Tensor
    r0: torch.Tensor
    solver_it: torch.Tensor  # int64
    diff_norm: torch.Tensor
    grad_norm: torch.Tensor
    f_best: torch.Tensor  # running-min f as a two-float pair
    f_best_lo: torch.Tensor


class GramCheckpoint(NamedTuple):
    """Stored per trace checkpoint; x materializes as gamma*x0 + A^T zeta."""

    gamma: torch.Tensor
    zeta: torch.Tensor
    Ax: torch.Tensor
    x_sqnorm: torch.Tensor


def _gram_value(gd: GramData, Ax, x_sqnorm, l2, adt, Ax_lo=None):
    """f from margins as a two-float (hi, lo) pair; batches over leading
    axes of ``Ax``. Terms are scaled by 1/n before the reduction. With
    ``Ax_lo`` the margin-linear part (1-b)*m sums as a compensated dot
    against the margin pair and the bounded nonlinear part -logsig(m)
    takes a first-order lo correction (krylov_crn_tpu's docstring has the
    error analysis)."""
    scale = over_n(gd.mask, gd.n)
    if Ax_lo is not None:
        p = ((1.0 - gd.b) * scale).to(adt)
        hi, lo = dot2(p, Ax.to(adt))
        lo = lo + (p * Ax_lo.to(adt)).sum(-1)
        nl = -logsig(Ax) * scale
        nhi, nlo = accum_sum_pair(nl.to(adt), adt)
        hi, e = two_sum(hi, nhi)
        lo = lo + e + nlo
        corr = (sigmoid(Ax) - 1.0) * scale * Ax_lo
        lo = lo + corr.to(adt).sum(-1)
    else:
        terms = ((1.0 - gd.b) * Ax - logsig(Ax)) * scale
        hi, lo = accum_sum_pair(terms.to(adt), adt)
    if l2:
        t = (l2 / 2.0) * x_sqnorm.to(adt)
        hi, e = two_sum(hi, t)
        lo = lo + e
    return hi, lo


def _x_sqnorm(gd: GramData, gamma, zeta, Ax, adt, Ax_lo=None):
    """|x|^2 = g^2|x0|^2 + 2g Ax0.zeta + zeta.K zeta, with
    K zeta = Ax - g Ax0 (margins invariant); batches over leading axes."""
    z = zeta.to(adt)
    g = gamma.to(adt)
    out = (g * g * gd.x0_sqnorm.to(adt) + g * (z @ gd.Ax0.to(adt))
           + (z * Ax.to(adt)).sum(-1))
    if Ax_lo is not None:
        out = out + (z * Ax_lo.to(adt)).sum(-1)
    return out


def _candidate_df(gd: GramData, Ax, inc, adt):
    """Difference-form loss change for candidate margin increments
    ``inc`` (shape (L, n) or (n,)):

        dphi = (1-b).delta + [softplus(-m-delta) - softplus(-m)]

    with the bracket as log1p(sigmoid(-m) * expm1(-delta)) for |delta| < 15
    and as the direct softplus difference beyond (where the log1p form
    overflows in fp32). Returns the change as an (hi, lo) pair."""
    n = gd.n
    p = over_n((1.0 - gd.b) * gd.mask, n).to(adt)
    sig_neg = sigmoid(-Ax)
    scale = over_n(gd.mask, n)
    lin_hi, lin_lo = dot2(p, inc.to(adt))
    inc_s = torch.clamp(inc, -15.0, 15.0)
    nl_log1p = torch.log1p(sig_neg * torch.expm1(-inc_s))
    nl_direct = softplus(-(Ax + inc)) - softplus(-Ax)
    nl = scale * torch.where(torch.abs(inc) < 15.0, nl_log1p, nl_direct)
    shi, slo = accum_sum_pair(nl.to(adt), adt)
    hi, e = two_sum(lin_hi, shi)
    return hi, lin_lo + e + slo


def _mm(a, b):
    """fp32 mat-mat product at full fp32 (TF32 is off, config.py)."""
    return torch.matmul(a, b)


def _lr_matvec(K_lr, q, mesh=None):
    """K_lr @ q for the bf16 K with fp32 accumulation, in q's dtype. As
    in the JAX package (``dot_general`` of K_lr and q in bf16 with an fp32
    result) q is rounded to bf16 first; every product of two bf16 values
    is then exact in fp32, and the result differs from the JAX package's
    by summation order only. On a card this is the bf16 path of the matvec
    kernel (ops/matvec.py), on the CPU its plain version. Under a ``mesh``
    of several ranks K_lr is this rank's band: its product, then one
    all-gather. ``_lr_matvec.cuda_calls`` counts the calls on a card."""
    if K_lr.is_cuda:
        _lr_matvec.cuda_calls += 1
    y = matvec(K_lr, q.to(torch.bfloat16).float())
    if mesh is not None and mesh.distributed:
        y = all_gather_rows(mesh, y)
    return y.to(q.dtype)


_lr_matvec.cuda_calls = 0


def _refresh_images(gd: GramData, Vb, Vw):
    """The basis images through the fp32 K: Vu = Vb Ax0 + Vw K (K is
    symmetric), K streamed once for all m rows. Under a mesh each rank
    multiplies its band, K_band Vw^T, and one all-gather of the (band, m)
    results gives the whole (n_pad, m)."""
    if gd.mesh is not None and gd.mesh.distributed:
        VwK = all_gather_rows(gd.mesh, _mm(gd.K, Vw.T)).T
    else:
        VwK = _mm(Vw, gd.K)
    return Vb[:, None] * gd.Ax0[None, :] + VwK


def _pick(t, idx):
    """t[idx] along the first axis for a 1-element index tensor, without a
    host read of the index."""
    return t.index_select(0, idx).squeeze(0)


def gram_krylov_step(
    gd: GramData,
    state: GramKrylovState,
    m: int = 10,
    l2: float = 0.0,
    beta: float = 0.5,
    solver_eps: float = 1e-8,
    solver_it_max: int = 100,
    ls_max: int = 20,
    reorth_passes: int = 1,
    accum_dtype=None,
    reg_ceil: float = 1e6,
    use_lr: bool = True,
) -> GramKrylovState:
    """One Krylov-CRN iteration with the batched line search: all
    ls_max + 1 candidate regularizations are solved at once (secular
    Newton over a batch axis, one (L,m)x(m,n) product for all candidate
    margins) and the first acceptable one is selected — the same accept
    decision as the reference's sequential loop (cubic.py:294-303). On an
    all-reject the iterate is frozen and reg rises one notch.

    ``use_lr`` with a ``gd.K_lr``: the m Lanczos matvecs run on the bf16
    K (``_lr_matvec``), and the basis images are then recomputed through
    the fp32 K, because the line search's trial margins and the committed
    state read them (bf16's ~2e-3 relative error there accepts steps that
    raise the true f). The uK matvec stays fp32 (SYMV). Under a mesh such
    a step makes m + 2 all-gathers (m + 1 without the bf16 K) and no
    all-reduce."""
    cdt = state.zeta.dtype
    adt = state.zeta.dtype if accum_dtype is None else accum_dtype
    n = gd.n
    L = ls_max + 1
    dev = state.zeta.device

    gamma, zeta, Ax, Ax_lo, value = (state.gamma, state.zeta, state.Ax,
                                     state.Ax_lo, state.value)

    # gradient rep: g = l2*gamma * x0 + A^T (residual/n + l2*zeta);
    # sigma evaluated from the margin pair (first-order in lo)
    sig0 = sigmoid(Ax)
    sig = sig0 + sig0 * (1.0 - sig0) * Ax_lo
    residual = (sig - gd.b) * gd.mask
    w_new = over_n(residual, n) + (l2 * zeta if l2 else 0.0)
    # incremental gradient image: the fresh matvec runs on the step-sized dw
    dw = w_new - state.w_g
    uK = state.uK + k_matvec(gd.K, dw, gd.mesh)
    beta_g = l2 * gamma
    u_g = beta_g * gd.Ax0 + uK
    g = Rep(beta_g, w_new, u_g)

    D = over_n(sig * (1.0 - sig) * gd.mask, n)
    lr = use_lr and gd.K_lr is not None

    def hop(v: Rep) -> Rep:
        q = D * v.u
        w_H = q + (l2 * v.w if l2 else 0.0)
        Kq = (_lr_matvec(gd.K_lr, q, gd.mesh) if lr
              else k_matvec(gd.K, q, gd.mesh))
        u_H = Kq + (l2 * v.u if l2 else 0.0)
        return Rep(l2 * v.beta, w_H, u_H)

    lz = gram_lanczos(gd, hop, g, m, reorth_passes=reorth_passes,
                      accum_dtype=adt)
    if lr:
        lz = lz._replace(Vu=_refresh_images(gd, lz.Vb, lz.Vw))

    g_norm = torch.sqrt(torch.clamp(rep_dot(gd, g, g, adt), min=0.0))

    # ---- batched line search over all candidate regularizations ----
    ks = torch.arange(L, dtype=adt, device=dev)
    regs = state.reg_coef.to(adt) * beta * (1.0 / beta) ** ks
    # the tridiagonal's eigh and every candidate's secular Newton, in one
    # launch on a card (no host read)
    theta, Q, lams, its = tridiag_secular(
        lz.alphas.to(adt), lz.betas.to(adt), g_norm, regs, state.r0.to(adt),
        xtol=solver_eps, it_max=solver_it_max)
    c = g_norm * Q[0, :]
    # (L, m); zero-weight modes contribute a zero step, not 0/0
    denom = theta[None, :] + lams[:, None]
    cz = c[None, :] != 0
    U = torch.where(cz, -c[None, :] / torch.where(cz, denom, 1.0), 0.0)
    S = U @ Q.T  # (L, m) steps in Lanczos coordinates
    norm_s = torch.sqrt(torch.sum(U * U, dim=1))
    model_decs = (lams / 2.0 * norm_s ** 2 - regs / 3.0 * norm_s ** 3
                  - g_norm * S[:, 0] / 2.0)
    S_c = S.to(cdt)
    gammas = gamma + S_c @ lz.Vb  # (L,)
    zetas = zeta[None, :] + _mm(S_c, lz.Vw)  # (L, n_pad)
    # candidate margins as two-float pairs: the increment is added with an
    # error-free two-sum so the committed pair carries the exact update
    inc = _mm(S_c, lz.Vu)  # (L, n_pad)
    Axs, inc_err = two_sum(Ax[None, :], inc)
    Axs_lo = Ax_lo[None, :] + inc_err

    if l2:
        # absolute candidate values (the l2 term needs |x|^2)
        xsqs = _x_sqnorm(gd, gammas, zetas, Axs, adt, Ax_lo=Axs_lo)
        vhis, vlos = _gram_value(gd, Axs, xsqs, l2, adt, Ax_lo=Axs_lo)
        dfhs, errs = two_sum(vhis, -value)
        dfls = errs + (vlos - state.value_lo)
    else:
        # difference-form candidate evaluation: error proportional to the
        # decrease at any gap scale
        dfhs, dfls = _candidate_df(gd, Ax, inc, adt)
        vhis, es = two_sum(value, dfhs)
        vlos = state.value_lo + es + dfls

    # accept test on the pair decrease (NaN -> not ok); below one ulp of
    # f any non-increase up to that ulp is accepted
    gaps_c = dfhs + dfls
    ulp = torch.finfo(value.dtype).eps * torch.abs(value).to(adt)
    ok = ((gaps_c <= -model_decs)
          | ((model_decs <= ulp) & (gaps_c <= ulp)))
    any_ok = ok.any()
    idx = torch.where(any_ok, torch.argmax(ok.to(torch.int32)), 0).reshape(1)

    gamma_new = torch.where(any_ok, _pick(gammas, idx), gamma)
    zeta_new = torch.where(any_ok, _pick(zetas, idx), zeta)
    value_new = torch.where(any_ok, _pick(vhis, idx), value)
    value_new_lo = torch.where(any_ok, _pick(vlos, idx), state.value_lo)
    s_c = torch.where(any_ok, _pick(S_c, idx), 0.0)
    Ax_new = torch.where(any_ok, _pick(Axs, idx), Ax)
    Ax_lo_new = torch.where(any_ok, _pick(Axs_lo, idx), Ax_lo)

    # ||x_new - x|| through the rep of the delta; a frozen (all-reject)
    # iteration reports inf, not 0
    delta = Rep(torch.dot(s_c, lz.Vb), s_c @ lz.Vw, s_c @ lz.Vu)
    diff_norm = torch.where(
        any_ok, torch.sqrt(torch.clamp(rep_dot(gd, delta, delta, adt),
                                       min=0.0)),
        float("inf"))

    better = pair_diff(value_new, value_new_lo,
                       state.f_best, state.f_best_lo) < 0
    reg_new = torch.where(any_ok, _pick(regs, idx),
                          state.reg_coef.to(adt) / beta)
    return GramKrylovState(
        gamma=gamma_new, zeta=zeta_new, Ax=Ax_new, Ax_lo=Ax_lo_new,
        w_g=w_new, uK=uK,
        value=value_new, value_lo=value_new_lo,
        reg_coef=reg_clamp(reg_new, reg_ceil).to(cdt),
        r0=torch.where(any_ok, _pick(lams, idx),
                       state.r0.to(adt)).to(cdt),
        solver_it=state.solver_it + _pick(its, idx),
        diff_norm=diff_norm.to(cdt),
        grad_norm=g_norm.to(cdt),
        f_best=torch.where(better, value_new, state.f_best),
        f_best_lo=torch.where(better, value_new_lo, state.f_best_lo),
    )


def gram_krylov_multistep(gd: GramData, state: GramKrylovState,
                          chunk: int = 16, stack_reps: bool = False, **kw):
    """``chunk`` eager iterations with no host read (on a card, where the
    subproblem kernel runs the Newton loops); returns the final state plus
    per-iteration ((value, value_lo), grad_norm, diff_norm, solver_it)
    stacks, and with ``stack_reps`` each iteration's (gamma, zeta) rep for
    post-hoc exact evaluation. ``GramKrylov.run_fused`` replays captured
    steps instead on one card (``GramKrylov._step_graphs``); this is its
    path under a mesh of several ranks and on the CPU."""
    rows = []
    for _ in range(chunk):
        state = gram_krylov_step(gd, state, **kw)
        rows.append(state)
    stack = lambda name: torch.stack([getattr(s, name) for s in rows])
    return state, _chunk_outs(stack, stack_reps)


def _chunk_outs(stack, stack_reps):
    """A chunk's stacks in ``gram_krylov_multistep``'s layout, from
    ``stack(name)``, the chunk's rows of one state field."""
    out = ((stack("value"), stack("value_lo")), stack("grad_norm"),
           stack("diff_norm"), stack("solver_it"))
    if stack_reps:
        out = out + ((stack("gamma"), stack("zeta")),)
    return out


# the state fields a chunk stacks, and those it stacks with ``stack_reps``
_ROWS = ("value", "value_lo", "grad_norm", "diff_norm", "solver_it")
_REP_ROWS = ("gamma", "zeta")

# a step's kernels, by their Python counters: a graph replay launches what
# the captured step launched, and adds what its capture counted
_COUNTERS = ((symv, "launches"), (k_matvec, "cuda_calls"),
             (_lr_matvec, "cuda_calls"), (matvec, "launches"),
             (matvec, "shape_launches"), (tridiag_secular, "launches"),
             (fold, "launches"))
# what a chunk's replays count (``gram.replay``): the folds and the steps
_REPLAY_COUNTS = ((fold, "launches"), (gram_krylov_step, "graph_replays"))


def _rows(state: GramKrylovState, stack_reps: bool, cap: int, device):
    """Zeroed chunk stacks for ``cap`` rows of each field a chunk stacks."""
    return {n: torch.zeros((cap,) + tuple(getattr(state, n).shape),
                           dtype=getattr(state, n).dtype, device=device)
            for n in _ROWS + (_REP_ROWS if stack_reps else ())}


def _capture_step(graphs: StepGraphs, gd: GramData, kw: dict, use_lr: bool,
                  stack_reps: bool, key):
    """Capture one ``gram_krylov_step`` on ``gd`` as the graph of ``key``
    over the static buffers of ``graphs`` (``state``, which holds the state
    the warm step starts from, ``rows`` and ``pos``): the step reads the
    state, writes it back, writes its rows at ``pos`` and advances it."""
    names = _ROWS + (_REP_ROWS if stack_reps else ())

    def body():
        out = gram_krylov_step(gd, graphs.state, use_lr=use_lr, **kw)
        for n in names:
            graphs.rows[n].index_copy_(0, graphs.pos,
                                       getattr(out, n).unsqueeze(0))
        for dst, src in zip(graphs.state, out):
            dst.copy_(src)
        graphs.pos.add_(1)

    return graphs.capture(key, body, lambda: gram_krylov_step(
        gd, graphs.clone(), use_lr=use_lr, **kw))


def _replay_chunk(graphs: StepGraphs, entry, k: int, stack_reps: bool):
    """k replays of ``entry`` from the state loaded into ``graphs.state``:
    the final state and the chunk's stacks, as ``gram_krylov_multistep``
    returns them."""
    graphs.pos.zero_()
    graphs.replay(entry, k)
    return graphs.clone(), _chunk_outs(
        lambda n: graphs.rows[n][:k].clone(), stack_reps)


class _StepGraphs(StepGraphs):
    """``gram_krylov_step`` captured as CUDA graphs (``utils/graphs``),
    for one GramKrylov instance on one card: the graphs of a GramData with
    a bf16 ``K_lr``. The head's step reads K through cuBLAS
    (``_refresh_images``), which bakes K's address into the graph, so these
    graphs serve one GramData. (Every other GramData on one card replays
    the graphs that the process keeps, ``_GraphCache``.)

    Every graph reads the state from the static buffers ``state``, writes
    the new state back into them, writes the step's rows (``_ROWS``, and
    ``_REP_ROWS`` with ``stack_reps``) into the chunk stacks ``rows`` at
    the device-side index ``pos`` and advances it. A chunk of k iterations
    is then: the state copied in, ``pos`` zeroed, k replays, the state and
    the first k rows cloned out; the host reads nothing in between.

    Graphs are keyed on what the JAX package keys its jit on (``use_lr``,
    ``stack_reps``, the step's keyword arguments, which hold m and the
    accumulation dtype) and on the data pointers of K and K_lr; they all
    read the buffers of one GramData, which a new one drops."""

    def __init__(self, device):
        super().__init__(device, _COUNTERS,
                         (gram_krylov_step, "graph_captures"),
                         (gram_krylov_step, "graph_replays"))
        self.gd = None
        self.rows = {}
        self.pos = None

    def _buffers(self, state: GramKrylovState, chunk: int,
                 stack_reps: bool):
        """Static buffers like ``state`` with room for ``chunk`` rows."""
        cap = self.rows["value"].shape[0] if self.rows else 0
        if cap < chunk or (stack_reps and "zeta" not in self.rows):
            self.state = None  # the rows grow: new buffers, no graph
        if not self.buffers(state):
            return
        self.rows = _rows(state, stack_reps or "zeta" in self.rows,
                          max(cap, chunk), self.device)
        self.pos = torch.zeros(1, dtype=torch.int64, device=self.device)

    def graph(self, gd: GramData, state: GramKrylovState, kw: dict,
              use_lr: bool, stack_reps: bool, chunk: int):
        """The graph of one step under these arguments, with the counts a
        replay adds; captured at first use (``state`` is loaded for it)."""
        use_lr = bool(use_lr and gd.K_lr is not None)
        if self.gd is not gd:
            self.graphs.clear()
            self.gd = gd
        self._buffers(state, chunk, stack_reps)
        key = (use_lr, bool(stack_reps), tuple(sorted(kw.items())),
               gd.K.data_ptr(),
               gd.K_lr.data_ptr() if gd.K_lr is not None else 0)
        entry = self.graphs.get(key)
        if entry is None:
            self.load(state)
            entry = _capture_step(self, gd, kw, use_lr, stack_reps, key)
        return entry

    def run(self, entry, state: GramKrylovState, k: int, stack_reps: bool):
        """k replays of ``entry`` from ``state``: the final state and the
        chunk's stacks, as ``gram_krylov_multistep`` returns them."""
        with span("gram.replay", counts=_REPLAY_COUNTS):
            self.load(state)
            return _replay_chunk(self, entry, k, stack_reps)


class _SlotGraphs(StepGraphs):
    """One graph of a card's ``_GraphCache``: ``gram_krylov_step`` under
    one key, over static buffers of its own (``state``, the chunk stacks
    ``rows``, ``pos``, as in ``_StepGraphs``) and ``view``, a GramData of
    static parts. The view's K is a ``KSlot`` (``ops/symv``), whose SYMV
    reads K at the address in the slot; its Ax0, b, mask and x0_sqnorm are
    copies. ``bind`` points the view at the GramData of the chunk at hand,
    so the graph serves every GramData of its key's shape, and nothing here
    keeps one alive."""

    def __init__(self, device, stream, gd: GramData, state: GramKrylovState,
                 stack_reps: bool, chunk: int):
        super().__init__(device, _COUNTERS,
                         (gram_krylov_step, "graph_captures"),
                         (gram_krylov_step, "graph_replays"))
        self.stream = stream
        self.view = dataclasses.replace(
            gd, K=KSlot(gd.n_padded, gd.K.dtype, device),
            Ax0=torch.empty_like(gd.Ax0), b=torch.empty_like(gd.b),
            mask=torch.empty_like(gd.mask),
            x0_sqnorm=torch.empty_like(gd.x0_sqnorm), mesh=None, K_lr=None)
        self.buffers(state)
        self.rows = _rows(state, stack_reps, chunk, device)
        self.pos = torch.zeros(1, dtype=torch.int64, device=device)
        self.entry = None

    def bind(self, gd: GramData):
        """Point the view at ``gd``, on the current stream: K's address
        into the slot, the small arrays into the static copies."""
        view = self.view
        view.K.point(gd.K)
        for dst, src in ((view.Ax0, gd.Ax0), (view.b, gd.b),
                         (view.mask, gd.mask),
                         (view.x0_sqnorm, gd.x0_sqnorm)):
            dst.copy_(src)


CACHE_SIZE = 4  # graphs a card's _GraphCache keeps


class _GraphCache:
    """The Gram step graphs of one card, kept for the life of the process,
    as the JAX package keeps its compiled chunk programs: at most
    ``CACHE_SIZE`` ``_SlotGraphs`` (the one asked for least recently is
    dropped first), and one capture stream that they share, so one cuBLAS
    workspace. The graphs of every GramData without a K_lr on this card.

    The key is what the JAX package keys its jit on: n (a Python constant
    inside the step, ``over_n``), n_pad, the dtypes of the arrays the step
    reads, the step's keyword arguments, ``stack_reps``, and the rows that
    the chunk stacks hold. A GramKrylov that follows another of the same
    shape replays its graph: no eager warm step, no recording, no new
    stream."""

    def __init__(self, device):
        self.device = device
        self.stream = None
        self.members = collections.OrderedDict()

    def graph(self, gd: GramData, state: GramKrylovState, kw: dict,
              use_lr: bool, stack_reps: bool, chunk: int):
        """The graph of one step under these arguments (``use_lr`` is off
        without a K_lr), for ``run``: captured at first use (``state`` is
        loaded for it). The entry holds ``gd`` for ``run``; the cache does
        not."""
        key = (gd.n, gd.n_padded,
               tuple(t.dtype for t in (gd.K, gd.Ax0, gd.b, gd.mask,
                                       gd.x0_sqnorm)),
               tuple(sorted(kw.items())), bool(stack_reps), int(chunk))
        member = self.members.get(key)
        if member is not None:
            self.members.move_to_end(key)
            return member, gd
        member = _SlotGraphs(self.device, self.stream, gd, state, stack_reps,
                             chunk)
        member.bind(gd)
        member.load(state)
        member.entry = _capture_step(member, member.view, kw, False,
                                     stack_reps, key)
        self.stream = member.stream
        self.members[key] = member
        while len(self.members) > CACHE_SIZE:
            self.members.popitem(last=False)
        return member, gd

    def run(self, entry, state: GramKrylovState, k: int, stack_reps: bool):
        """k replays of ``entry`` from ``state`` on the entry's GramData:
        the final state and the chunk's stacks, as
        ``gram_krylov_multistep`` returns them."""
        member, gd = entry
        with span("gram.replay", counts=_REPLAY_COUNTS):
            member.bind(gd)
            member.load(state)
            return _replay_chunk(member, member.entry, k, stack_reps)


_CACHES: dict = {}  # torch.device -> its _GraphCache


def _graph_cache(device) -> _GraphCache:
    """The process's ``_GraphCache`` of ``device``."""
    cache = _CACHES.get(device)
    if cache is None:
        cache = _CACHES[device] = _GraphCache(device)
    return cache


def _clear_graph_caches():
    """Drop every cached graph (each card keeps its capture stream)."""
    for cache in _CACHES.values():
        cache.members.clear()


gram_krylov_step.graph_captures = 0
gram_krylov_step.graph_replays = 0
# graphs that ``warm_fused`` asked for and found already captured (a card's
# _GraphCache held them), beside ``graph_captures``; its span counts both
gram_krylov_step.graph_reuses = 0
_WARM_COUNTS = ((gram_krylov_step, "graph_captures"),
                (gram_krylov_step, "graph_reuses"))


def _init_state_packed(Ax0, buf, npad):
    """Initial state from one packed buffer [Ax_lo; w_g; uK; value_hi,
    value_lo, reg_coef] (one host-to-device copy)."""
    cdt, dev = Ax0.dtype, Ax0.device
    s = buf[3 * npad:3 * npad + 3]
    value, value_lo = s[0], s[1]
    inf = torch.tensor(float("inf"), dtype=cdt, device=dev)
    return GramKrylovState(
        gamma=torch.ones((), dtype=cdt, device=dev),
        zeta=torch.zeros(npad, dtype=cdt, device=dev),
        Ax=Ax0, Ax_lo=buf[:npad], w_g=buf[npad:2 * npad],
        uK=buf[2 * npad:3 * npad],
        value=value, value_lo=value_lo,
        reg_coef=s[2], r0=torch.tensor(0.1, dtype=cdt, device=dev),
        solver_it=torch.zeros((), dtype=torch.int64, device=dev),
        diff_norm=inf, grad_norm=inf,
        f_best=value, f_best_lo=value_lo,
    )


def _apply_correction(state: GramKrylovState, buf, npad: int,
                      full: bool = False):
    """Unpack one host-corrected buffer [margins; lo; w_g; uK; scalars]
    (+ zeta with ``full``) into the state. ``full`` also restores
    gamma/zeta/reg_coef/r0/solver_it: the rollback to a verified
    snapshot."""
    s = buf[4 * npad:4 * npad + 8]
    st = state._replace(Ax=buf[:npad], Ax_lo=buf[npad:2 * npad],
                        w_g=buf[2 * npad:3 * npad],
                        uK=buf[3 * npad:4 * npad],
                        value=s[0], value_lo=s[1], f_best=s[2],
                        f_best_lo=s[3])
    if full:
        inf = torch.full_like(s[0], float("inf"))
        st = st._replace(gamma=s[4], reg_coef=s[5], r0=s[6],
                         solver_it=s[7].to(torch.int64),
                         zeta=buf[5 * npad:6 * npad],
                         diff_norm=inf, grad_norm=inf)
    return st


def _checkpoint_of(gd: GramData, state: GramKrylovState, adt):
    xsq = _x_sqnorm(gd, state.gamma, state.zeta, state.Ax, adt,
                    Ax_lo=state.Ax_lo)
    return GramCheckpoint(gamma=state.gamma, zeta=state.zeta,
                          Ax=state.Ax, x_sqnorm=xsq)


def _fetch(tensors):
    """Host numpy copies of several device tensors through ONE transfer
    (cast to fp64: exact for fp32 values and for counters below 2^53)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    flat = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        k = t.numel()
        out.append(flat[o:o + k].reshape(tuple(t.shape)))
        o += k
    return out


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _exact_value(A, Ax0_64, b01, gamma, zeta64, l2, x0):
    """Exact fp64 (value, margins, A^T zeta) of the rep (gamma, zeta) on
    the host, through the sparse A (two scipy SpMVs)."""
    t = A.T.dot(zeta64)
    margins = gamma * Ax0_64 + A.dot(t)
    ls = np.where(margins < 0, margins - np.log1p(np.exp(margins)),
                  -np.log1p(np.exp(-margins)))
    value64 = float(np.mean((1.0 - b01) * margins - ls))
    if l2:
        x = gamma * x0 + t
        value64 += 0.5 * l2 * float(x @ x)
    return value64, margins


class RepMaterializer:
    """Picklable rep -> x converter: x = gamma * x0 + A^T zeta on the host
    (one transpose SpMV), returned as a numpy vector in zeta's dtype."""

    def __init__(self, x0, loss=None):
        self.x0 = np.asarray(x0, np.float64)
        self.loss = loss

    def __call__(self, ck):
        if self.loss is None:
            raise ValueError(
                "RepMaterializer has no loss attached; load the trace via "
                "Trace.from_pickle(path, loss=...) to materialize iterates")
        A = self.loss.A_host
        zeta = _np(ck.zeta)
        z = np.asarray(zeta, np.float64)[: A.shape[0]]
        x = float(ck.gamma) * self.x0 + A.T.dot(z)
        return x.astype(zeta.dtype)


class GramKrylov(Optimizer):
    """Krylov CRN over the Gram-space representation, on ``device``.

    Requires the oracle's host scipy matrix (LogisticRegression keeps it)
    for the one-time K build and the exact host corrections. A pre-built
    ``gram_data`` (same A, same x0) skips the K build and keeps its own
    ``K_lr``. ``mesh`` (several ranks, every rank constructing the same
    solver): K row-banded over the ranks on the mesh's device.
    ``cache_dir``: where a host build of K (on the CPU) keeps it
    (``build_gram``); a card builds K on the device and reads no cache.

    ``bf16_head`` (fp32 runs): the Lanczos matvecs run on a bf16 copy of K
    until the gradient norm falls below ``fp32_tail_rtol`` times the first
    one recorded, then on the fp32 K (``_maybe_enter_fp32_tail``). Off by
    default, as in the JAX package, where it moved rcv1-like's 1e-8
    crossing from iteration 33 to 57."""

    local_fields = ()  # under a mesh every Gram state field is replicated

    def __init__(self, reg_coef=None, subspace_dim=100, solver_eps=1e-8,
                 beta=0.5, solver_it_max=100, ls_max=20, reorth_passes=1,
                 cache_dir=None, mesh=None, fp32_tail_rtol=1e-3,
                 gram_data=None, bf16_head=False, device=None, *args,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._gd_preset = gram_data
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None and device is None:
            device = self.mesh.device
        self.device = (gram_data.K.device if gram_data is not None
                       and device is None else resolve_device(device))
        self.subspace_dim = int(subspace_dim)
        self.solver_eps = float(solver_eps)
        self.solver_it_max = int(solver_it_max)
        self.beta = float(beta)
        self.ls_max = int(ls_max)
        self.reorth_passes = int(reorth_passes)
        self.cache_dir = cache_dir
        self.bf16_head = bool(bf16_head)
        self.fp32_tail_rtol = float(fp32_tail_rtol)
        self._gn_first = None
        self._use_lr = self.bf16_head
        self.reg_coef = (self.loss.hessian_lipschitz if reg_coef is None
                         else float(reg_coef))
        self.gd: GramData | None = None
        self._x0_host = None
        self._graphs: _StepGraphs | None = None

    def _maybe_enter_fp32_tail(self, grad_norm):
        """Leave the bf16 K for the fp32 K once the tail begins: when the
        gradient norm falls below ``fp32_tail_rtol`` times the first one
        recorded (the JAX package's rule; ``run_fused`` records the first
        entry of its first accepted chunk). Once off, it stays off for the
        run."""
        if not self._use_lr or self.gd is None or self.gd.K_lr is None:
            return
        grad_norm = float(grad_norm)
        if not np.isfinite(grad_norm):
            return
        if self._gn_first is None:
            self._gn_first = grad_norm
            return
        if grad_norm < self.fp32_tail_rtol * self._gn_first:
            self._use_lr = False

    def init_state(self, x0, seed):
        loss = self.loss
        A = loss.A_host
        x0h = np.asarray(x0, np.float64)
        self._x0_host = x0h
        self._gn_first = None
        self._use_lr = self.bf16_head
        # a second run on the same instance must not reuse the previous
        # run's exact-correction constants
        self._Ax0_64 = None
        self._b01_64 = None
        self._f_best_exact = None
        dtype = loss.dtype
        npad = pad_rows(A.shape[0])

        # exact fp64 margins pair + initial gradient image (w_g, uK) on the
        # host (three sparse SpMVs): the incremental invariants start exact
        n_real = A.shape[0]
        with span("gram.init_state", host=True):
            m64 = A.dot(x0h)
            b64 = np.asarray(loss.b, np.float64)[:n_real]
            w64 = (expit(m64) - b64) / n_real  # zeta = 0: no l2 term yet
            uK64 = A.dot(A.T.dot(w64))
            ls = np.where(m64 < 0, m64 - np.log1p(np.exp(m64)),
                          -np.log1p(np.exp(-m64)))
            value64 = float(np.mean((1.0 - b64) * m64 - ls))
            if loss.l2:
                value64 += 0.5 * loss.l2 * float(x0h @ x0h)
            # value rides as a storage-dtype two-float pair; Ax_lo is
            # m64 - fl(Ax0) with the same host cast the build uses for Ax0
            vhi = dtype.type(value64)
            buf = np.zeros(3 * npad + 3, dtype)
            buf[:n_real] = (m64 - m64.astype(dtype).astype(np.float64)
                            ).astype(dtype)
            buf[npad:npad + n_real] = w64.astype(dtype)
            buf[2 * npad:2 * npad + n_real] = uK64.astype(dtype)
            buf[3 * npad:3 * npad + 3] = (
                vhi, dtype.type(value64 - float(vhi)), self.reg_coef)
        self.loss.reset()
        self.trace.solver_its = [0]

        if self._gd_preset is not None:
            gd = self._gd_preset
            if not np.isclose(float(gd.x0_sqnorm), float(x0h @ x0h),
                              rtol=1e-5):
                raise ValueError(
                    "gram_data was built for a different x0 "
                    f"(|x0|^2={float(gd.x0_sqnorm):.6g} vs "
                    f"{float(x0h @ x0h):.6g})")
            self.gd = gd
        else:
            self.gd = build_gram(A, loss.b[:n_real], x0h, dtype=dtype,
                                 cache_dir=self.cache_dir,
                                 low_res_lanczos=self.bf16_head
                                 and dtype == np.float32,
                                 device=self.device, mesh=self.mesh)
        return _init_state_packed(self.gd.Ax0,
                                  torch.from_numpy(buf).to(self.device), npad)

    def _step_kwargs(self):
        return dict(
            m=self.subspace_dim, l2=self.loss.l2, beta=self.beta,
            solver_eps=self.solver_eps, solver_it_max=self.solver_it_max,
            ls_max=self.ls_max, reorth_passes=self.reorth_passes,
            accum_dtype=accum_dtype(self.state.zeta.dtype),
            reg_ceil=max(1e6, 1e4 * float(self.reg_coef)),
        )

    def step(self):
        self.state = gram_krylov_step(self.gd, self.state,
                                      use_lr=self._use_lr,
                                      **self._step_kwargs())
        self._maybe_enter_fp32_tail(self.state.grad_norm)

    # ---- trace integration (checkpoints are reps, not iterates) ----
    def update_trace(self):
        st = self.state
        ck = _checkpoint_of(self.gd, st, accum_dtype(st.zeta.dtype))
        self.trace.xs.append(ck)
        self.trace.ts.append(self.t)
        self.trace.its.append(self.it)
        self.trace.solver_its.append(int(st.solver_it))

    def init_run(self, x0, seed):
        with span("gram.init_run"):
            super().init_run(x0, seed)
            # at x = x0 the checkpoint is closed-form (gamma=1, zeta=0,
            # Ax=Ax0)
            st = self.state
            self.trace.xs = [GramCheckpoint(
                gamma=st.gamma, zeta=st.zeta, Ax=st.Ax,
                x_sqnorm=self.gd.x0_sqnorm)]
            self.trace.materializer = RepMaterializer(self._x0_host,
                                                      self.loss)

    def _ensure_exact_setup(self):
        """Host fp64 constants of the exact corrections (lazy, so
        step-by-step runs can use corrections too)."""
        if self._Ax0_64 is None:
            A = self.loss.A_host
            with span("gram.exact_setup", host=True):
                self._Ax0_64 = A.dot(self._x0_host)
                self._b01_64 = np.asarray(self.loss.b,
                                          np.float64)[:A.shape[0]]
            self._f_best_exact = (float(self.state.value)
                                  + float(self.state.value_lo))

    def _exact_reinject(self, gamma, zeta64, reg=None, r0=None,
                        solver_it=None):
        """Exact fp64 (margins, value, gradient image) from a host
        (gamma, zeta) rep, reinjected as one packed host-to-device copy.
        With reg/r0/solver_it given, also restores those (the rollback of
        run_fused's trust-but-verify loop)."""
        st = self.state
        A = self.loss.A_host
        n = A.shape[0]
        full = reg is not None
        l2 = self.loss.l2
        cdt = np.dtype(str(st.Ax.dtype).removeprefix("torch."))
        npad = st.Ax.shape[0]
        # the host's part alone: the span closes before the upload
        with span("gram.rollback" if full else "gram.reinject", host=True):
            value64, margins = _exact_value(A, self._Ax0_64, self._b01_64,
                                            gamma, zeta64, l2, self._x0_host)
            # exact gradient image: resets the incremental (w_g, uK)
            # invariant
            w64 = (expit(margins) - self._b01_64) / n
            if l2:
                w64 = w64 + l2 * zeta64
            uK64 = A.dot(A.T.dot(w64))
            vhi = cdt.type(value64)
            vlo = cdt.type(value64 - float(vhi))
            self._f_best_exact = min(self._f_best_exact, value64)
            bhi = cdt.type(self._f_best_exact)
            blo = cdt.type(self._f_best_exact - float(bhi))
            buf = np.zeros((6 if full else 5) * npad, cdt)
            buf[:n] = margins.astype(cdt)
            buf[npad:npad + n] = (margins
                                  - buf[:n].astype(np.float64)).astype(cdt)
            buf[2 * npad:2 * npad + n] = w64.astype(cdt)
            buf[3 * npad:3 * npad + n] = uK64.astype(cdt)
            buf[4 * npad:4 * npad + 4] = (vhi, vlo, bhi, blo)
            if full:
                buf[4 * npad + 4:4 * npad + 8] = (gamma, reg, r0,
                                                  float(solver_it))
                buf[5 * npad:5 * npad + n] = zeta64.astype(cdt)
        self.state = _apply_correction(
            st, torch.from_numpy(buf).to(st.Ax.device), npad, full=full)
        return value64

    def _step_graphs(self):
        """The step graphs that ``run_fused`` replays, or None where it runs
        eagerly: under a mesh of several ranks (gloo's collectives cannot
        be captured) and on the CPU. On one card: the instance's own where
        the GramData has a K_lr (``_StepGraphs``), else the card's graphs
        that the process keeps (``_GraphCache``)."""
        if self.mesh is not None or not self.state.zeta.is_cuda:
            return None
        dev = self.state.zeta.device
        if self.gd.K_lr is None:
            return _graph_cache(dev)
        if self._graphs is None:
            self._graphs = _StepGraphs(dev)
        return self._graphs

    def warm_fused(self, chunk=16, certify=False):
        """Capture every step graph that a later ``run_fused(chunk=...,
        certify=...)`` replays, for both ``use_lr`` phases when the
        GramData has a K_lr, as the JAX package's ``warm_fused`` compiles
        every chunk program: one-time costs that a benchmark keeps out of
        its timed region. A graph that the process already holds for this
        shape (``_GraphCache``) is reused, not captured: its span counts
        both. Needs an initialized state (``init_run`` first); where
        ``run_fused`` runs eagerly it does nothing."""
        if self.state is None:
            raise ValueError("warm_fused needs an initialized state")
        graphs = self._step_graphs()
        if graphs is None:
            return
        cert = bool(certify) and self.state.zeta.dtype == torch.float32
        kw = self._step_kwargs()
        with span("gram.warm_fused", counts=_WARM_COUNTS):
            for lr in ((True, False) if self.gd.K_lr is not None
                       else (False,)):
                c0 = gram_krylov_step.graph_captures
                graphs.graph(self.gd, self.state, kw, lr, cert, chunk)
                if gram_krylov_step.graph_captures == c0:
                    gram_krylov_step.graph_reuses += 1

    def run_fused(self, x0, it_max, t_max=np.inf, chunk=16, seed=42,
                  certify=False):
        """Chunked run: ``chunk`` iterations between host syncs, with a
        full-resolution loss trace (wall-times interpolated within
        chunks). On one card each iteration is a replay of the captured
        step (``_step_graphs``; ``warm_fused`` captures ahead), so a chunk
        makes no host read; under a mesh of several ranks and on the CPU
        the steps run eagerly (``gram_krylov_multistep``).

        fp32 runs get an exact correction at every chunk boundary: the
        margins, gradient image and f are recomputed exactly in fp64 on
        the host and reinjected; a chunk that does not improve the exact
        f is rolled back to the last verified snapshot and retried one
        iteration at a time (trust-but-verify). ``metrics["exact_its"]``
        / ``["exact_fs"]`` hold the exact values (every iterate with
        ``certify``, evaluated after the run), and
        ``["boundary_its"]`` / ``["boundary_fs"]`` the exact values at
        accepted chunk boundaries, which never increase."""
        with span("gram.run_fused"):
            return self._run_fused(x0, it_max, t_max, chunk, seed, certify)

    def _run_fused(self, x0, it_max, t_max, chunk, seed, certify):
        self.t_max = t_max
        self.it_max = it_max
        if not self.initialized:
            self.init_run(x0, seed)
            self.initialized = True
        exact = self.state.zeta.dtype == torch.float32
        if exact:
            self._Ax0_64 = None
            self._ensure_exact_setup()
        cert = bool(certify) and exact
        kw = self._step_kwargs()
        v0h, v0l = _fetch([self.state.value, self.state.value_lo])
        self.trace.loss_vals = [float(v0h) + float(v0l)]
        metrics = self.trace.metrics
        metrics.setdefault("grad_norm", [])
        metrics.setdefault("diff_norm", [])
        if exact:
            for key in ("exact_its", "exact_fs", "boundary_its",
                        "boundary_fs", "rollback_its", "rollback_fs"):
                metrics.setdefault(key, [])
        cert_stacks = []  # (first_it, k, reps-on-device) of accepted chunks
        self.t_start = time.perf_counter()
        t_prev = 0.0
        n_real = self.gd.n
        chunk_cur = chunk
        rollbacks = 0
        rejects_at_1 = 0
        if exact:
            # the initial state is host-exact: the first verified snapshot
            snap = dict(gamma=1.0, zeta=np.zeros(n_real),
                        reg=float(self.reg_coef), r0=0.1, solver_it=0,
                        f=self.trace.loss_vals[0])
        graphs = self._step_graphs()
        while self.it < it_max:
            k = int(min(chunk_cur, it_max - self.it))
            # the bf16 head's switch holds for a whole chunk, as in the
            # JAX package, where it is a static argument of the chunk
            if graphs is not None:
                entry = graphs.graph(self.gd, self.state, kw, self._use_lr,
                                     cert, chunk)
                self.state, outs = graphs.run(entry, self.state, k, cert)
            else:
                self.state, outs = gram_krylov_multistep(
                    self.gd, self.state, chunk=k, stack_reps=cert,
                    use_lr=self._use_lr, **kw)
            vpairs, gns, dns, sits = outs[:4]
            reps = outs[4] if cert else None
            # ONE bundled device-to-host copy per chunk
            fetch = [vpairs[0], vpairs[1], gns, dns, sits]
            if exact:
                fetch += [self.state.gamma, self.state.reg_coef,
                          self.state.r0, self.state.zeta]
            with span("gram.fetch"):
                got = _fetch(fetch)
            now = self.elapsed()
            vals = got[0] + got[1]
            gns, dns, sits = got[2], got[3], got[4].astype(np.int64)
            # under a mesh, every rank must branch below on the same bits
            # (the trust-but-verify decision, the stops): compare them
            # first and fail on all ranks rather than hang
            replicated = dict(values=vals, diff_norm=dns, chunk=k)
            if exact:
                gamma_h = float(got[5])
                zeta_h = got[8][:n_real]
                value64 = self._exact_reinject(gamma_h, zeta_h)
                replicated.update(gamma=gamma_h, zeta=zeta_h,
                                  reg_coef=got[6], r0=got[7],
                                  value64=value64)
            check_replicated(self.mesh, "at the chunk boundary after "
                             f"iteration {self.it + k}", **replicated)
            if exact:
                # trust-but-verify: a chunk must IMPROVE THE EXACT f to be
                # kept; otherwise roll back to the verified snapshot and
                # retry one iteration at a time, raising reg on repeated
                # single-iteration failures
                if value64 >= snap["f"]:
                    rollbacks += 1
                    metrics["rollback_its"].append(self.it)
                    metrics["rollback_fs"].append(value64)
                    if rollbacks >= 64:
                        self._exact_reinject(
                            snap["gamma"], snap["zeta"], reg=snap["reg"],
                            r0=snap["r0"], solver_it=snap["solver_it"])
                        break
                    if k == 1:
                        rejects_at_1 += 1
                        if rejects_at_1 >= 6:
                            break
                    else:
                        chunk_cur = 1
                    self._exact_reinject(
                        snap["gamma"], snap["zeta"],
                        reg=float(self.reg_coef) * (4.0 ** rejects_at_1),
                        r0=snap["r0"], solver_it=snap["solver_it"])
                    t_prev = now
                    self.t = now
                    if now >= t_max:
                        break
                    continue
                rejects_at_1 = 0
                chunk_cur = chunk
                snap = dict(gamma=gamma_h, zeta=zeta_h.copy(),
                            reg=float(got[6]), r0=float(got[7]),
                            solver_it=int(sits[k - 1]), f=value64)
            metrics["grad_norm"].extend(gns[:k])
            metrics["diff_norm"].extend(dns[:k])
            if self._gn_first is None and np.isfinite(gns[0]):
                self._gn_first = float(gns[0])
            self._maybe_enter_fp32_tail(np.min(gns[:k]))
            for j in range(k):
                self.it += 1
                self.trace.its.append(self.it)
                self.trace.ts.append(t_prev + (now - t_prev) * (j + 1) / k)
                self.trace.loss_vals.append(float(vals[j]))
                self.trace.solver_its.append(int(sits[j]))
            if exact:
                self.trace.loss_vals[-1] = value64
                for key in ("exact", "boundary"):
                    metrics[f"{key}_its"].append(self.it)
                    metrics[f"{key}_fs"].append(value64)
            if cert:
                # the rep stacks stay on the device during the run;
                # _certify_stacks reads them afterwards
                cert_stacks.append((self.it - k + 1, k, reps))
            t_prev = now
            self.t = now
            self.update_trace_checkpoint_only()
            if (self.tolerance > 0 and np.isfinite(dns[k - 1])
                    and dns[k - 1] < self.tolerance):
                break
            if now >= t_max:
                break
        if cert and cert_stacks:
            self._certify_stacks(cert_stacks, metrics)
        self.trace.loss_vals = np.asarray(self.trace.loss_vals)
        if exact:
            f_best = self._f_best_exact
        else:
            f_best = float(self.state.f_best) + float(self.state.f_best_lo)
        if f_best < self.loss.f_opt:
            self.loss.f_opt = f_best
            self.loss.x_opt = self.current_x()
        self.initialized = False
        self.finished_seeds.append(seed)
        return self.trace

    def _certify_stacks(self, cert_stacks, metrics):
        """Exact fp64 host evaluation of EVERY stacked iterate after the
        run: exact_its/exact_fs go from chunk-boundary to per-iteration
        resolution, each value from the committed (gamma, zeta) rep
        through the sparse host matrix."""
        A = self.loss.A_host
        n_real = self.gd.n
        exact_its, exact_fs = [], []
        with span("gram.certify"):
            for first_it, k, (g_dev, z_dev) in cert_stacks:
                with span("gram.certify.fetch"):
                    gammas, zetas = _fetch([g_dev, z_dev])
                with span("gram.certify.eval", host=True):
                    for j in range(k):
                        it = first_it + j
                        v64, _ = _exact_value(
                            A, self._Ax0_64, self._b01_64, float(gammas[j]),
                            zetas[j, :n_real], self.loss.l2, self._x0_host)
                        exact_its.append(it)
                        exact_fs.append(v64)
                        # the full-resolution trace entry becomes ground
                        # truth
                        if it < len(self.trace.loss_vals):
                            self.trace.loss_vals[it] = v64
                        self._f_best_exact = min(self._f_best_exact, v64)
        metrics["exact_its"] = exact_its
        metrics["exact_fs"] = exact_fs

    def update_trace_checkpoint_only(self):
        adt = accum_dtype(self.state.zeta.dtype)
        self.trace.xs.append(_checkpoint_of(self.gd, self.state, adt))

    def materialize(self, ck: GramCheckpoint):
        """x = gamma * x0 + A^T zeta (one transpose SpMV, on demand)."""
        return RepMaterializer(self._x0_host, self.loss)(ck)

    def best_value(self):
        """Where fp32 iterates were pinned to exact host values, the best
        exact fp64 value counts too: the fp32 pair that holds it may read
        a few fp64 ulps above it, and f* must lie at or below every
        certified value."""
        f = super().best_value()
        if self._Ax0_64 is not None:
            f = min(f, self._f_best_exact)
        return f

    def current_x(self):
        """Materialized current iterate (for loss.x_opt tracking)."""
        st = self.state
        return self.materialize(GramCheckpoint(
            gamma=st.gamma, zeta=st.zeta, Ax=st.Ax, x_sqnorm=None))

    def compute_loss_of_iterates(self):
        """O(n) per checkpoint from stored margins. Values fold into
        ``loss.f_opt`` only in fp64 runs (fp32 checkpoints keep only the
        margin hi part, whose noise must not define the empirical f*)."""
        if len(self.trace.loss_vals):
            return
        adt = accum_dtype(self.gd.K.dtype)
        vals = []
        for ck in self.trace.xs:
            hi, lo = _gram_value(self.gd, ck.Ax, ck.x_sqnorm,
                                 self.loss.l2, adt)
            v = float(hi) + float(lo)
            if adt == torch.float64 and v < self.loss.f_opt:
                self.loss.f_opt = v
            vals.append(v)
        self.trace.loss_vals = np.asarray(vals)
