"""Batched node-frontier branch-and-bound for hybrid MPC.

Port of ``linearmpc_tpu/ops/bnb_frontier.py`` (``FrontierState``,
``make_xla_relax``, ``make_pallas_relax`` as ``make_kernel_relax``,
``solve_bnb_frontier``, ``IncState``, ``solve_bnb_frontier_inc`` as
``IncFrontier``, ``_refined_polish`` as ``refined_polish``, ``ChunkState``
and ``make_frontier_rounds`` as ``FrontierRounds``). Every lane keeps its
own node stack; a round advances every lane at once:

* ``solve_bnb_frontier`` pops one node per lane and solves the whole
  frontier of node relaxations as one batched dual active-set solve (the
  ``relax`` of ``make_xla_relax``: the float64 GI loop ``iu.iterate_iu``
  with a per-lane equality mask, or the masked-Cholesky loop with the
  full-row feasibility check; or ``make_kernel_relax``, a cold K3 launch),
  then branches, prunes and updates incumbents. Child nodes warm-start
  from the parent's multipliers and working set.
* ``IncFrontier`` keeps the GI solver state (multipliers, working set,
  pending candidate, carried inverse R) across rounds: each round runs
  the stepper's K iterations of every lane (K3's resumable entry,
  ``iu.step_iu``), then a management step branches or prunes the lanes
  whose relaxation converged. At a branch the near child continues the
  parent's state in place (only the branched row clamps); a backtrack pop
  restarts from the root relaxation's snapshot. Every quantity of a round
  is per lane, so on CUDA ``solve`` runs the whole search in one launch of
  K3's search entry (``iu.search_iu``, a warp a lane alternating K
  iterations and the management), as the JAX package runs it in one
  ``while_loop`` on its device; on the CPU it runs the rounds on the
  plain step (``search_plain``, the kernel's plain version, on either
  device). This is the engine's
  float32 hybrid path where K3's routing rule admits m (m <= 66).
* ``FrontierRounds`` keeps each lane's current node relaxation (the
  masked-Cholesky scheme with a carried Woodbury-updated inverse,
  ``dual_active_set._active_set_loop_wu``) across bounded rounds of
  24 iterations, with best-first node selection: the float32
  engine's path beyond that rule, on the float64 node arrays. It is the
  JAX engine's path for these problems on its accelerator, and its
  best-first order and its capped status (2) are part of the result, so
  the port runs the rounds rather than the float64 frontier.

Management runs in the engine dtype, in float32 under the engine's
``full_f32`` (the JAX package's ``Precision.HIGHEST``); the incremental
frontier's sums run in its search kernel's order (``lane_sum``, row sums
in index order), so on the card kernel and rounds agree bit for bit. The
status rules are the JAX package's (``:391-403``, ``:754-778``).
Deliberate differences:
lanes without a node are not re-solved (the JAX relax solves every lane
and discards those); the pops that discard nodes whose bound reaches the
incumbent (``prune_tops``) are one count per lane, not a loop with a host
sync per pop; the state is batch-major with ``(pend, pend_side)`` in place
of a signed one-hot; no batch padding to 128 lanes (the kernels take any
batch). The only host sync of an incremental round is its loop condition;
the search entry makes none.

The final incumbent is re-solved in float64 from its working set, so
branching in float32 costs accuracy only in which near-tied node wins (an
incumbent of equal value may differ in U), never in the returned controls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..profiling import count, span
from . import iu
from .bnb import BIG, BIN_TOL
from .bulk import ordered_matvec
from .dual_active_set import (
    LDPArrays,
    Solution,
    _active_set_loop,
    _active_set_loop_wu,
    _bmv,
    _primal_feasible,
    masked_system,
    newton_schulz,
    polish_solution,
    woodbury_rank2,
)


class FrontierState(NamedTuple):
    """The pop-per-round frontier's state (batch-major)."""

    stack_fixed: torch.Tensor  # (B, cap, m) bool: binary rows fixed at a bound
    stack_side: torch.Tensor   # (B, cap, m) bool: which bound (True = upper)
    stack_lam: torch.Tensor    # (B, cap, m) warm-start multipliers
    stack_act: torch.Tensor    # (B, cap, m) bool warm-start working set
    stack_ws: torch.Tensor     # (B, cap, m) bool warm-start working-set sides
    stack_bound: torch.Tensor  # (B, cap) parent relaxation value (lower bound)
    top: torch.Tensor          # (B,) int64
    inc_fval: torch.Tensor     # (B,)
    inc_lam: torch.Tensor      # (B, m)
    inc_active: torch.Tensor   # (B, m) bool
    inc_side: torch.Tensor     # (B, m) bool
    inc_found: torch.Tensor    # (B,) bool
    nodes: torch.Tensor        # (B,) int32
    iters: torch.Tensor        # (B,) int32
    exhausted: torch.Tensor    # (B,) bool: a node was pruned unconverged
    capped: torch.Tensor       # (B,) bool: a node relaxation hit its iteration cap


class IncState(NamedTuple):
    """The incremental frontier's state: the GI solver state ``gi`` lives
    across rounds (batch-major, as K3 takes it)."""

    stack_fixed: torch.Tensor  # (B, cap, m) bool
    stack_side: torch.Tensor   # (B, cap, m) bool
    stack_bound: torch.Tensor  # (B, cap)
    top: torch.Tensor          # (B,) int64
    cur_fixed: torch.Tensor    # (B, m) bool: current node's fixed binaries
    cur_fside: torch.Tensor    # (B, m) bool
    active_node: torch.Tensor  # (B,) bool: the lane is solving a node
    node_iter: torch.Tensor    # (B,) int32: iterations spent on the current node
    du_l: torch.Tensor         # (B, m) float32 current node bounds (clamped)
    dl_l: torch.Tensor
    eq_l: torch.Tensor         # (B, m) bool
    gi: iu.IUState             # the solver state K3 resumes
    root: tuple                # (lam, act, side, R) of the root relaxation: a
    #   valid warm start for every node of the lane (R depends only on the
    #   working set, not on the bounds)
    root_saved: torch.Tensor   # (B,) bool
    ray_retry: torch.Tensor    # (B,) bool: the current node was already cold-retried
    inc_fval: torch.Tensor     # (B,)
    inc_active: torch.Tensor   # (B, m) bool
    inc_side: torch.Tensor     # (B, m) bool
    inc_found: torch.Tensor    # (B,) bool
    nodes: torch.Tensor        # (B,) int32
    iters: torch.Tensor        # (B,) int32
    exhausted: torch.Tensor    # (B,) bool
    rounds: torch.Tensor       # (B,) int32: rounds the lane was solving a node
    retries: torch.Tensor      # (B,) int32: cold ray retries


def prune_tops(top, inc_found, inc_fval, stack_bound):
    """Pop (discard) the stacked nodes whose parent bound already reaches
    the incumbent, from the top of each lane's stack down, without a solve:
    the loop of ``bnb_frontier.py:245-259`` as one count per lane, the
    cumulative product from the top down of ``inc_found & (bound >=
    inc_fval)`` (entries at or above the top count as prunable)."""
    cap = stack_bound.shape[1]
    pos = torch.arange(cap, device=top.device)
    q = (pos >= top[:, None]) | (inc_found[:, None] & (stack_bound >= inc_fval[:, None]))
    run = q.flip(1).to(torch.int32).cumprod(1).flip(1)
    return top - (run * (pos < top[:, None])).sum(1)


def lane_sum(terms):
    """Row sums of (B, n) ``terms`` in the order of the search kernel's
    warp (``csrc/inc_search.cu::warp_sum``): thread t adds entries t,
    t + 32, ... in turn, then a butterfly adds the 32 partial sums."""
    B, n = terms.shape
    w = -(-n // 32) * 32
    t = torch.nn.functional.pad(terms, (0, w - n)).reshape(B, w // 32, 32)
    p = t[:, 0]
    for k in range(1, w // 32):
        p = p + t[:, k]
    for o in (16, 8, 4, 2, 1):  # thread i adds thread i ^ o's sum: the pairs swapped
        p = p + p.reshape(B, 16 // o, 2, o).flip(2).reshape(B, 32)
    return p[:, 0]


def _take(x, j):
    return x.gather(1, j[:, None])[:, 0]


def _objective(arr: LDPArrays, U0, f_t, lam):
    U = U0 - lam @ arr.HinvET.T
    return U, 0.5 * ((U @ arr.H.T) * U).sum(1) + (f_t * U).sum(1)


def _theta_terms(arr: LDPArrays, thetas):
    th = thetas.to(arr.G.dtype)
    dt = th @ arr.Dth.T
    return (arr.du + dt, arr.dl + dt, arr.u_off + th @ arr.Uth_off.T,
            arr.f + th @ arr.f_theta.T)


def make_xla_relax(arr: LDPArrays, *, max_iter: int, primal_tol: float, sign_tol: float,
                   mode: str = "iu") -> Callable:
    """Node-relaxation solver in the dtype of ``arr`` (the float64 path).

    ``mode="iu"``: the GI inverse-update loop ``iu.iterate_iu`` (the JAX
    package's ``_active_set_loop_iu``), with dual-ray infeasibility
    detection. ``mode="cholesky"``: the masked-Cholesky loop, the scheme
    that converges on massively dual-degenerate relaxations (the contact
    problem, m > 64); a converged node is checked against the full row set
    (``_primal_feasible``) and a failed check counts as unconverged, never
    as infeasible. Returns ``relax(du_n, dl_n, eq_lane, lam0, act0, side0)
    -> (lam, act, side, iters, done, infeas, capped)``."""
    dtype = arr.G.dtype
    if mode == "cholesky":
        def relax(du_n, dl_n, eq_lane, lam0, act0, side0):
            st = _active_set_loop(arr, du_n, dl_n, lam0.to(dtype), act0, side0,
                                  max_iter=max_iter, primal_tol=primal_tol,
                                  sign_tol=sign_tol, use_cholesky=True, eq=eq_lane)
            feas = _primal_feasible(arr, du_n, dl_n, st.lam, st.active, st.side, primal_tol)
            return (st.lam, st.active, st.side, st.iters, st.done & feas,
                    torch.zeros_like(feas), ~st.done)

        return relax
    if mode != "iu":
        raise ValueError(f"mode must be 'iu' or 'cholesky', got {mode!r}")
    m = arr.G.shape[0]
    eye = torch.eye(m, dtype=dtype, device=arr.G.device)
    Gs = arr.G_solve + 4.0 * torch.finfo(dtype).eps * eye

    def relax(du_n, dl_n, eq_lane, lam0, act0, side0):
        st = iu.iterate_iu(arr.G, Gs, du_n, dl_n, eq_lane, arr.is_immutable, lam0.to(dtype),
                           act0, side0, iu.init_R_batch(arr.G_solve, act0),
                           max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)
        return (st.lam, st.act, st.side, st.iters, st.done, st.infeas,
                ~st.done & ~st.infeas)

    return relax


def make_kernel_relax(G, Gs, immut, *, max_iter: int, primal_tol: float,
                      sign_tol: float) -> Callable:
    """Node-relaxation solver on K3 (``iu.phase1_iu`` with a per-lane
    ``eq``; the port of ``make_pallas_relax`` with its default ``cold``)
    in the dtype of ``G``: every node starts from an empty working set with
    R = I (one matrix for every lane), ignoring the warm start it is
    given, and its rays are trusted."""
    dtype, dev = G.dtype, G.device
    m = G.shape[0]
    R0 = torch.eye(m, dtype=dtype, device=dev)

    def relax(du_n, dl_n, eq_lane, lam0, act0, side0):
        B = du_n.shape[0]
        zb = torch.zeros((B, m), dtype=torch.bool, device=dev)
        lam, act, side, it, done, infeas, _R = iu.phase1_iu(
            G, Gs, du_n.to(dtype).contiguous(), dl_n.to(dtype).contiguous(), eq_lane, immut,
            torch.zeros((B, m), dtype=dtype, device=dev), zb, ~zb, R0,
            max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)
        return lam, act, side, it, done, infeas, ~done & ~infeas

    return relax


def _status(found, budgeted, unresolved):
    one = torch.ones(found.shape[0], dtype=torch.int32, device=found.device)
    return torch.where(found, torch.where(budgeted, 2 * one, one),
                       torch.where(unresolved, -one, -2 * one))


def _result(sol: Solution, found, act, side, iters, status) -> Solution:
    fm = found[:, None]
    return Solution(torch.where(fm, sol.U, 0.0), torch.where(fm, sol.lam, 0.0), act, side,
                    torch.where(found, sol.fval, BIG), iters, status)


def solve_bnb_frontier(arr: LDPArrays, arr_hi: LDPArrays | None, thetas, relax: Callable, *,
                       stack_cap: int = 64, node_limit: int = 1024,
                       use_cholesky: bool = True, warm_nodes: bool = True) -> Solution:
    """Solve a batch of hybrid LDP instances with one popped node per lane
    a round, the popped nodes' relaxations solved together by ``relax``
    (``bnb_frontier.py:200-420``). The incumbents are re-solved from their
    working sets in the precision of ``arr_hi`` (``arr`` when None)."""
    dtype, dev = arr.G.dtype, arr.G.device
    thetas = torch.as_tensor(thetas, device=dev)
    B, m = thetas.shape[0], arr.G.shape[0]
    big = BIG
    idx = torch.arange(m, device=dev)
    du_t, dl_t, U0, f_t = _theta_terms(arr, thetas)
    branchable_rows = arr.is_binary & ~arr.is_immutable & (arr.up_finite | arr.lo_finite)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    cap_w = stack_cap if warm_nodes else 1
    s = FrontierState(
        stack_fixed=zb(B, stack_cap, m), stack_side=zb(B, stack_cap, m),
        stack_lam=torch.zeros((B, cap_w, m), dtype=dtype, device=dev),
        stack_act=zb(B, cap_w, m),
        stack_ws=torch.ones((B, cap_w, m), dtype=torch.bool, device=dev),
        stack_bound=torch.full((B, stack_cap), -big, dtype=dtype, device=dev),
        top=torch.ones(B, dtype=torch.int64, device=dev),  # root: nothing fixed, cold
        inc_fval=torch.full((B,), big, dtype=dtype, device=dev),
        inc_lam=torch.zeros((B, m), dtype=dtype, device=dev),
        inc_active=zb(B, m), inc_side=zb(B, m), inc_found=zb(B),
        nodes=torch.zeros(B, dtype=torch.int32, device=dev),
        iters=torch.zeros(B, dtype=torch.int32, device=dev),
        exhausted=zb(B), capped=zb(B))

    while bool(((s.top > 0) & (s.nodes < node_limit)).any()):
        top = prune_tops(s.top, s.inc_found, s.inc_fval, s.stack_bound)
        s.top.copy_(top)
        r = torch.nonzero((top > 0) & (s.nodes < node_limit)).squeeze(1)
        if r.numel() == 0:
            continue
        t = top[r] - 1
        fixed, fside = s.stack_fixed[r, t], s.stack_side[r, t]
        eq_lane = arr.is_eq | fixed
        dut, dlt = du_t[r], dl_t[r]
        d_f = torch.where(fside, dut, dlt)
        du_n, dl_n = torch.where(fixed, d_f, dut), torch.where(fixed, d_f, dlt)
        n = r.numel()
        if warm_nodes:
            lam0 = s.stack_lam[r, t]
            act0 = s.stack_act[r, t] | eq_lane
            side0 = torch.where(fixed, fside, s.stack_ws[r, t])
        else:
            lam0 = torch.zeros((n, m), dtype=dtype, device=dev)
            act0, side0 = zb(n, m), torch.ones((n, m), dtype=torch.bool, device=dev)
        lam, act, side, it_in, done, infeas, capped = relax(du_n, dl_n, eq_lane, lam0,
                                                            act0, side0)
        lam = lam.to(dtype)
        _U, fval = _objective(arr, U0[r], f_t[r], lam)
        feasible = done & ~infeas
        unconverged = ~done & ~infeas
        found, fbest = s.inc_found[r], s.inc_fval[r]
        pruned = ~feasible | (found & (fval >= fbest))

        # fractionality of unfixed binary rows: distance to the nearer
        # viable bound (as ops/bnb.py)
        c = lam @ arr.G.T
        slack_up = torch.where(arr.up_finite, dut + c, big)
        slack_lo = torch.where(arr.lo_finite, -dlt - c, big)
        frac = torch.where(branchable_rows & ~fixed, torch.minimum(slack_up, slack_lo), -big)
        jb = frac.argmax(1)
        integral = _take(frac, jb) <= BIN_TOL

        better = feasible & integral & ~pruned & (fval < fbest)
        bt = better[:, None]
        s.inc_fval[r] = torch.where(better, fval, fbest)
        s.inc_lam[r] = torch.where(bt, lam, s.inc_lam[r])
        # pin every fixed binary row at its branched bound and side: the f64
        # polish solves the unclamped problem, where a clamped row satisfied
        # with zero multiplier would not be in the working set
        s.inc_active[r] = torch.where(bt, act | fixed, s.inc_active[r])
        s.inc_side[r] = torch.where(bt, torch.where(fixed, fside, side), s.inc_side[r])
        s.inc_found[r] = found | better

        # branch on jb: push the far bound first, the near one last (popped next)
        branch = ~pruned & ~integral
        onehot = idx == jb[:, None]
        child_fixed = fixed | onehot
        near_up = _take(slack_up, jb) <= _take(slack_lo, jb)
        nu = near_up[:, None]
        far_viable = torch.where(near_up, arr.lo_finite[jb], arr.up_finite[jb])
        # an unconverged parent's value is not a valid bound for its children
        child_bound = torch.where(unconverged, -big, fval)

        def push(t, node_side, ws_side, do):
            do = do & (t < stack_cap)
            ix = t.clamp(max=stack_cap - 1)
            d = do[:, None]
            s.stack_fixed[r, ix] = torch.where(d, child_fixed, s.stack_fixed[r, ix])
            s.stack_side[r, ix] = torch.where(d, node_side, s.stack_side[r, ix])
            if warm_nodes:
                s.stack_lam[r, ix] = torch.where(d, lam, s.stack_lam[r, ix])
                s.stack_act[r, ix] = torch.where(d, act, s.stack_act[r, ix])
                s.stack_ws[r, ix] = torch.where(d, ws_side, s.stack_ws[r, ix])
            s.stack_bound[r, ix] = torch.where(do, child_bound, s.stack_bound[r, ix])
            return t + do.to(t.dtype)

        t = push(t, torch.where(onehot, ~nu, fside), torch.where(onehot, ~nu, side),
                 branch & far_viable)
        t = push(t, torch.where(onehot, nu, fside), torch.where(onehot, nu, side), branch)
        s.top[r] = t
        s.nodes[r] += 1
        s.iters[r] += it_in.to(torch.int32)
        s.exhausted[r] |= unconverged
        s.capped[r] |= capped

    # a lane whose node relaxation hit its iteration cap, or that hit the
    # node limit, may hold an exact incumbent but did not finish the tree:
    # status 2; `exhausted` (unconverged-node prunes) splits -1 from -2
    budgeted = s.capped | (s.nodes >= node_limit)
    status = _status(s.inc_found, budgeted, s.exhausted | budgeted)
    hi = arr if arr_hi is None else arr_hi
    sol = polish_solution(hi, thetas, s.inc_active, s.inc_side, use_cholesky=use_cholesky)
    return _result(sol, s.inc_found, s.inc_active, s.inc_side, s.iters, status)


class IncFrontier:
    """The incremental node-frontier B&B (``bnb_frontier.py:460-785``) over
    ``stepper(du_l, dl_l, eq_l, gi) -> (gi, steps)``, K3's resumable entry
    (``iu.make_iu_stepper``). ``solve`` runs the search, then ``finish``:
    on CUDA ``search`` (one launch of K3's search entry, no host sync), on
    the CPU ``search_plain`` (``init``, then ``round`` on the plain step
    while ``running``, the round's one host sync). The rounds are public
    so a caller can run and inspect them one at a time on either device,
    on K3's step entry or on the plain step."""

    def __init__(self, arr: LDPArrays, arr_hi: LDPArrays | None, stepper: iu.IUStepper, *,
                 stack_cap: int = 64, node_limit: int = 1024, node_cap: int = 200,
                 use_cholesky: bool = True):
        self.arr, self.arr_hi, self.stepper = arr, arr_hi, stepper
        self.stack_cap, self.node_limit, self.node_cap = stack_cap, node_limit, node_cap
        self.use_cholesky = use_cholesky
        self.branchable_rows = (arr.is_binary & ~arr.is_immutable
                                & (arr.up_finite | arr.lo_finite))
        m = arr.G.shape[0]
        self.eye = torch.eye(m, dtype=torch.float32, device=arr.G.device)
        self.idx = torch.arange(m, device=arr.G.device)
        self.rounds = 0

    def _prepare(self, thetas):
        arr = self.arr
        self.thetas = thetas = torch.as_tensor(thetas, device=arr.G.device)
        self.du_t, self.dl_t, self.U0, self.f_t = _theta_terms(arr, thetas)

    def init(self, thetas) -> IncState:
        self._prepare(thetas)
        return self._start()

    def _start(self) -> IncState:
        """Every lane at its root node, for the prepared batch."""
        arr, thetas = self.arr, self.thetas
        dtype, dev = arr.G.dtype, arr.G.device
        B, m, cap = thetas.shape[0], arr.G.shape[0], self.stack_cap
        self.bidx = torch.arange(B, device=dev)
        self.rounds = 0
        f32 = torch.float32
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        ones = lambda *s: torch.ones(s, dtype=torch.bool, device=dev)
        eye_b = self.eye.expand(B, m, m)
        gi = iu.IUState(
            lam=torch.zeros((B, m), dtype=f32, device=dev), act=zb(B, m), side=ones(B, m),
            pend=torch.full((B,), -1, dtype=torch.int64, device=dev), pend_side=ones(B),
            iters=torch.zeros(B, dtype=torch.int32, device=dev), done=zb(B), infeas=zb(B),
            R=eye_b)
        return IncState(
            stack_fixed=zb(B, cap, m), stack_side=zb(B, cap, m),
            stack_bound=torch.full((B, cap), -BIG, dtype=dtype, device=dev),
            top=torch.zeros(B, dtype=torch.int64, device=dev),
            cur_fixed=zb(B, m), cur_fside=zb(B, m),
            active_node=ones(B),  # the root is every lane's first node
            node_iter=torch.zeros(B, dtype=torch.int32, device=dev),
            du_l=self.du_t.to(f32), dl_l=self.dl_t.to(f32),
            eq_l=arr.is_eq.expand(B, m).clone(),
            gi=gi, root=(gi.lam, gi.act, gi.side, eye_b), root_saved=zb(B),
            ray_retry=zb(B), inc_fval=torch.full((B,), BIG, dtype=dtype, device=dev),
            inc_active=zb(B, m), inc_side=zb(B, m), inc_found=zb(B),
            nodes=torch.ones(B, dtype=torch.int32, device=dev),
            iters=torch.zeros(B, dtype=torch.int32, device=dev), exhausted=zb(B),
            rounds=torch.zeros(B, dtype=torch.int32, device=dev),
            retries=torch.zeros(B, dtype=torch.int32, device=dev))

    def running(self, s: IncState) -> bool:
        """Whether a lane still solves a node or can pop one (one host sync)."""
        return bool((s.active_node | ((s.top > 0) & (s.nodes < self.node_limit))).any())

    def round(self, s: IncState, plain: bool = False) -> IncState:
        """k_round GI iterations of every lane (``stepper``, or its plain
        version ``stepper.plain`` when ``plain``), then branch / prune /
        incumbent updates and backtrack pops. Tensors handed to the stepper
        are never modified in place afterwards."""
        arr, big, cap = self.arr, BIG, self.stack_cap
        dtype = arr.G.dtype
        du_t, dl_t, bidx = self.du_t, self.dl_t, self.bidx
        self.rounds += 1

        # ---- k_round iterations of every lane
        step = self.stepper.plain if plain else self.stepper
        gi, steps = step(s.du_l, s.dl_l, s.eq_l, s.gi)
        iters = s.iters + steps
        node_iter = s.node_iter + steps

        # ---- management
        done, infeas, act, side = gi.done, gi.infeas, gi.act, gi.side
        lam = gi.lam.to(dtype)
        conv = s.active_node & done & ~infeas
        nfail_exh = s.active_node & ~done & (node_iter >= self.node_cap)
        # a dual-ray verdict reached from warm carried state (root snapshot
        # + chained rank-2 updates) is not trusted: the node is re-solved
        # once from a cold start; only a ray found on the retry prunes it
        ray = s.active_node & done & infeas
        retry = ray & ~s.ray_retry
        nfail = (ray & s.ray_retry) | nfail_exh

        # U = U0 - HinvET lam, fval = U'HU / 2 + f_t'U and c = G lam, summed
        # as the search kernel sums them
        U = self.U0 - ordered_matvec(arr.HinvET, lam)
        fval = 0.5 * lane_sum(ordered_matvec(arr.H, U) * U) + lane_sum(self.f_t * U)
        pruned_conv = conv & s.inc_found & (fval >= s.inc_fval)
        c = ordered_matvec(arr.G, lam)
        # mid-solve bound pruning: every GI iterate is dual feasible, so the
        # dual value is a lower bound on the node optimum at every iteration
        d_side = torch.where(side, s.du_l, s.dl_l).to(dtype)
        gval = fval - lane_sum(torch.where(act, lam * (d_side + c), 0.0))
        prune_mid = (s.active_node & ~done & s.inc_found
                     & (gval >= s.inc_fval + 1e-4 * (1.0 + s.inc_fval.abs())))
        slack_up = torch.where(arr.up_finite, du_t + c, big)
        slack_lo = torch.where(arr.lo_finite, -dl_t - c, big)
        frac = torch.where(self.branchable_rows & ~s.cur_fixed,
                           torch.minimum(slack_up, slack_lo), -big)
        jb = frac.argmax(1)
        integral = _take(frac, jb) <= BIN_TOL

        # snapshot the root relaxation's solver state at its convergence
        save = conv & ~s.root_saved
        sv = save[:, None]
        root = (torch.where(sv, gi.lam, s.root[0]), torch.where(sv, act, s.root[1]),
                torch.where(sv, side, s.root[2]),
                torch.where(save[:, None, None], gi.R, s.root[3]))
        root_saved = s.root_saved | save

        better = conv & ~pruned_conv & integral & (fval < s.inc_fval)
        bt = better[:, None]
        inc_fval = torch.where(better, fval, s.inc_fval)
        # the recorded working set pins every fixed binary row at its
        # branched bound and side for the float64 polish of the unclamped
        # problem
        inc_active = torch.where(bt, act | s.cur_fixed, s.inc_active)
        inc_side = torch.where(bt, torch.where(s.cur_fixed, s.cur_fside, side), s.inc_side)
        inc_found = s.inc_found | better

        # ---- branch: push the far child, continue the near child in place
        branch = conv & ~pruned_conv & ~integral
        onehot = self.idx == jb[:, None]
        near_up = _take(slack_up, jb) <= _take(slack_lo, jb)
        child_fixed = s.cur_fixed | onehot
        far_side = torch.where(onehot, ~near_up[:, None], s.cur_fside)
        far_viable = torch.where(near_up, arr.lo_finite[jb], arr.up_finite[jb])
        do_push = branch & far_viable & (s.top < cap)
        ix = s.top.clamp(max=cap - 1)
        dom = do_push[:, None]
        s.stack_fixed[bidx, ix] = torch.where(dom, child_fixed, s.stack_fixed[bidx, ix])
        s.stack_side[bidx, ix] = torch.where(dom, far_side, s.stack_side[bidx, ix])
        s.stack_bound[bidx, ix] = torch.where(do_push, fval, s.stack_bound[bidx, ix])
        top = s.top + do_push.to(s.top.dtype)

        bm = onehot & branch[:, None]
        cur_fixed = torch.where(branch[:, None], child_fixed, s.cur_fixed)
        cur_fside = torch.where(bm, near_up[:, None], s.cur_fside)
        nodes = s.nodes + branch.to(torch.int32)
        # clamp the branched row's bounds and make it an equality row
        d_b = torch.where(near_up, _take(du_t, jb), _take(dl_t, jb)).to(torch.float32)
        du_l = torch.where(bm, d_b[:, None], s.du_l)
        dl_l = torch.where(bm, d_b[:, None], s.dl_l)
        eq_l = s.eq_l | bm
        # the near child resumes the parent's solver state
        done = done & ~branch

        finished = (conv & (pruned_conv | integral)) | nfail | prune_mid
        active_node = s.active_node & ~finished
        exhausted = s.exhausted | nfail_exh
        node_iter = torch.where(branch | finished | retry, 0, node_iter)
        ray_retry = torch.where(branch | finished, False, s.ray_retry | retry)

        # ---- backtrack pops for idle lanes (restart from the root snapshot)
        top = prune_tops(top, inc_found, inc_fval, s.stack_bound)
        can_pop = ~active_node & (top > 0) & (nodes < self.node_limit)
        pidx = (top - 1).clamp(min=0)
        pop_fixed, pop_fside = s.stack_fixed[bidx, pidx], s.stack_side[bidx, pidx]
        top = top - can_pop.to(top.dtype)
        nodes = nodes + can_pop.to(torch.int32)
        cp = can_pop[:, None]
        cur_fixed = torch.where(cp, pop_fixed, cur_fixed)
        cur_fside = torch.where(cp, pop_fside, cur_fside)
        active_node = active_node | can_pop

        d_f = torch.where(pop_fside, du_t, dl_t)
        du_l = torch.where(cp, torch.where(pop_fixed, d_f, du_t).to(torch.float32), du_l)
        dl_l = torch.where(cp, torch.where(pop_fixed, d_f, dl_t).to(torch.float32), dl_l)
        eq_l = torch.where(cp, arr.is_eq | pop_fixed, eq_l)
        # the root snapshot (cold zeros / identity before the root converged)
        g_lam = torch.where(cp, root[0], gi.lam)
        g_act = torch.where(cp, root[1], act)
        g_side = torch.where(cp, root[2], side)
        g_R = torch.where(can_pop[:, None, None], root[3], gi.R)
        pend = torch.where(can_pop, -1, gi.pend)
        g_infeas = infeas & ~can_pop
        # popped lanes resume; permanently idle lanes freeze in the kernel
        g_done = torch.where(can_pop, False, torch.where(~active_node, True, done))

        # ray-retry lanes restart the same node from a genuinely cold state
        # (not the root snapshot, whose R may hold the drift behind the ray)
        rt = retry[:, None]
        g_lam = torch.where(rt, 0.0, g_lam)
        g_act = g_act & ~rt
        g_side = g_side | rt
        pend = torch.where(retry, -1, pend)
        g_infeas = g_infeas & ~retry
        g_done = g_done & ~retry
        g_R = torch.where(retry[:, None, None], self.eye, g_R)
        gi = iu.IUState(g_lam, g_act, g_side, pend, gi.pend_side, gi.iters, g_done,
                        g_infeas, g_R)

        return IncState(s.stack_fixed, s.stack_side, s.stack_bound, top, cur_fixed,
                        cur_fside, active_node, node_iter, du_l, dl_l, eq_l, gi, root,
                        root_saved, ray_retry, inc_fval, inc_active, inc_side, inc_found,
                        nodes, iters, exhausted, s.rounds + s.active_node.to(torch.int32),
                        s.retries + retry.to(torch.int32))

    def search_plain(self, thetas) -> iu.SearchResult:
        """The search entry's plain version on any device: ``init``, then
        ``round`` on the plain step (``step_iu_plain``) while ``running``."""
        self._prepare(thetas)
        return self._search_plain()

    def _search_plain(self) -> iu.SearchResult:
        s = self._start()
        while self.running(s):
            s = self.round(s, plain=True)
        return iu.SearchResult(*(getattr(s, f) for f in iu.SearchResult._fields))

    def search(self, thetas) -> iu.SearchResult:
        """The whole search of every lane in one launch of K3's search entry
        (CUDA tensors only; no host sync)."""
        self._prepare(thetas)
        return self._search()

    def _search(self) -> iu.SearchResult:
        arr = self.arr
        return iu.search_iu(
            self.stepper, self.du_t, self.dl_t, arr.is_eq, arr.up_finite, arr.lo_finite,
            self.branchable_rows, arr.HinvET, arr.H, self.U0, self.f_t,
            stack_cap=self.stack_cap, node_cap=self.node_cap, node_limit=self.node_limit)

    def finish(self, s) -> Solution:
        """Statuses (``bnb_frontier.py:754-778``) and the float64 re-solve of
        each incumbent's working set, from the search's ``IncState`` or
        ``iu.SearchResult``."""
        # 1 = proven optimal; 2 = exact incumbent but budget-limited search
        # (this path's `exhausted` is budget-only: ray prunes are certified
        # by a cold retry)
        budgeted = s.exhausted | (s.nodes >= self.node_limit)
        status = _status(s.inc_found, budgeted, budgeted)
        with span("lmpc.bnb.polish"):
            if self.arr_hi is not None and self.arr.G.dtype == torch.float32:
                sol = refined_polish(self.arr, self.arr_hi, self.thetas, s.inc_active,
                                     s.inc_side)
            else:
                hi = self.arr if self.arr_hi is None else self.arr_hi
                sol = polish_solution(hi, self.thetas, s.inc_active, s.inc_side,
                                      use_cholesky=self.use_cholesky)
        # a found incumbent whose polish residual stalled is not optimal
        status = torch.where(s.inc_found & (sol.status != 1), -1, status)
        return _result(sol, s.inc_found, s.inc_active, s.inc_side, s.iters, status)

    def solve(self, thetas) -> Solution:
        """The search entry on CUDA, the rounds on the CPU; then ``finish``."""
        dev = self.arr.G.device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"the incremental frontier runs on cuda or cpu, got {dev}")
        with span("lmpc.bnb.prepare"):
            self._prepare(thetas)
        with span("lmpc.bnb.search"):
            res = self._search() if dev.type == "cuda" else self._search_plain()
        count("bnb.lanes", self.thetas.shape[0])
        count("bnb.nodes", res.nodes)
        count("bnb.iters", res.iters)
        with span("lmpc.bnb.finish"):
            return self.finish(res)


class ChunkState(NamedTuple):
    """The frontier rounds' state (batch-major): the current node's
    relaxation lives across rounds."""

    stack_fixed: torch.Tensor  # (B, cap, m) bool
    stack_side: torch.Tensor   # (B, cap, m) bool
    stack_lam: torch.Tensor    # (B, cap, m)
    stack_act: torch.Tensor    # (B, cap, m) bool
    stack_ws: torch.Tensor     # (B, cap, m) bool
    stack_bound: torch.Tensor  # (B, cap)
    stack_R: torch.Tensor      # (B, cap, m, m) float32: the parent's maintained
    #   inverse ((B, 1, 1, 1) in the reference mode)
    occ: torch.Tensor          # (B, cap) bool open-node occupancy ((B, 1) in
    #   the reference mode, where ``top`` is the stack)
    top: torch.Tensor          # (B,) int64 (the open-node count, best-first)
    cur_fixed: torch.Tensor    # (B, m) bool: the current node's fixed binaries
    cur_fside: torch.Tensor    # (B, m) bool
    lam: torch.Tensor          # (B, m) the current relaxation's state
    act: torch.Tensor          # (B, m) bool
    side: torch.Tensor         # (B, m) bool
    R: torch.Tensor            # (B, m, m) the carried ridged masked inverse
    #   ((B, 1, 1) in the reference mode)
    node_iter: torch.Tensor    # (B,) int32
    active_node: torch.Tensor  # (B,) bool
    inc_fval: torch.Tensor     # (B,)
    inc_lam: torch.Tensor      # (B, m)
    inc_active: torch.Tensor   # (B, m) bool
    inc_side: torch.Tensor     # (B, m) bool
    inc_found: torch.Tensor    # (B,) bool
    nodes: torch.Tensor        # (B,) int32
    iters: torch.Tensor        # (B,) int32
    exhausted: torch.Tensor    # (B,) bool: a node pruned unconverged or infeasible
    capped: torch.Tensor       # (B,) bool: the search hit a budget (status 2)
    reseeds: torch.Tensor      # (B,) int32: drift-certificate reseeds


class FrontierRounds:
    """Branch-and-bound in bounded rounds over masked-Cholesky-scheme node
    relaxations (``make_frontier_rounds``, ``bnb_frontier.py:866-1380``):
    the float32 engine's path at m >= 67, run on the float64 node arrays,
    as the JAX engine runs it on its accelerator (``engine.py:1328-1385``).

    A round advances every lane by at most ``K_CHUNK`` relaxation
    iterations, then branches, prunes and updates incumbents for the lanes
    whose node converged and pops a node for idle ones; it makes no host
    sync. ``solve`` blocks once every ``POLL_EVERY`` rounds, on whether any
    lane is still searching. The node relaxations run
    ``_active_set_loop_wu``: the ridged masked inverse (ridge ``max(100 m
    eps, 1e-8)``, the same in the seeds, the transitions and the loop) is
    carried across rounds and, in float32, through the stack for the far
    children, aligned at pops and branches by a rank-2 Woodbury add, and a
    per-round drift certificate ``max|I - M R|`` reseeds flagged lanes with
    a factorization (computed for every lane and selected, so the round
    needs no host decision). Nodes are popped best-first: the open node of
    least bound once an incumbent exists, deepest first before and when the
    open list nears capacity; a push that finds no free slot marks the lane
    capped (status 2). ``reference=True`` swaps both for the masked-Cholesky
    loop and the depth-first stack, and then the rounds reproduce
    ``solve_bnb_frontier`` with the Cholesky relax bit for bit (a check of
    the rounds' management, not a path of the engine).

    The best-first order and the capped status are part of the result
    (which incumbent of equal value wins, and the 1-versus-2 split), so the
    port keeps the rounds rather than running the float64 frontier.
    Deliberate difference: the reference clamps the float32 inverse stack
    at 1 GiB with a floor of 4 slots (``bnb_frontier.py:1326-1330``), below
    the depth-first bound nb + 1, which demotes lanes to status 2 by batch
    size; here the stack always holds ``stack_cap`` slots (an allocation
    the card cannot hold raises), so the result is a function of the
    inputs alone."""

    # the drift certificate's bound on max|I - M R|
    DRIFT_TOL = 1e-2
    # the loop's staleness gate stays off, as in the reference
    # (``bnb_frontier.py:918-922``): the certificate catches a degraded R
    STALE_TOL = 1e30
    # the JAX accelerator's round (engine.py:1328-1385): relaxation
    # iterations a round, rounds a host poll
    K_CHUNK = 24
    POLL_EVERY = 4

    def __init__(self, arr: LDPArrays, arr_hi: LDPArrays | None, *, stack_cap: int = 64,
                 node_limit: int = 1024, node_cap: int = 512, primal_tol: float = 1e-6,
                 sign_tol: float = 1e-11, use_cholesky: bool = True, reference: bool = False):
        self.arr, self.arr_hi = arr, arr_hi
        self.stack_cap, self.node_limit, self.node_cap = stack_cap, node_limit, node_cap
        self.primal_tol, self.sign_tol = primal_tol, sign_tol
        self.use_cholesky, self.reference = use_cholesky, reference
        dtype, dev = arr.G.dtype, arr.G.device
        m = arr.G.shape[0]
        self.nb = int(arr.is_binary.sum())
        # 1e-8 bounds ||R|| (G has a unit diagonal) and with it the Woodbury
        # round-off on degenerate working sets (bnb_frontier.py:949-964)
        self.ridge = max(100.0 * m * float(torch.finfo(dtype).eps), 1e-8)
        self.eye = torch.eye(m, dtype=dtype, device=dev)
        self.Gsr = arr.G_solve + self.ridge * self.eye
        self.idx = torch.arange(m, device=dev)
        self.branchable_rows = (arr.is_binary & ~arr.is_immutable
                                & (arr.up_finite | arr.lo_finite))
        self.last_state: ChunkState | None = None
        self.rounds = 0

    def seed_R(self, act):
        """A factorization of each lane's ridged masked system: batched
        Cholesky and two Newton-Schulz passes. A system that is not positive
        definite gives NaN, as ``jnp.linalg.cholesky`` does."""
        M0 = masked_system(self.Gsr, act.to(self.Gsr.dtype))
        L, info = torch.linalg.cholesky_ex(M0)
        R0 = torch.cholesky_solve(self.eye.expand_as(M0), L)
        R0 = torch.where((info != 0)[:, None, None], torch.nan, R0)
        for _ in range(2):
            R0 = torch.bmm(R0, 2.0 * self.eye - torch.bmm(M0, R0))
        return R0

    def wu_add(self, R, act_new, oh, do):
        """Rank-2 Woodbury add of the one-hot row ``oh`` (already in
        ``act_new``) into the ridged masked inverse and one Newton-Schulz
        pass, the in-loop update's add case; lanes where ``do`` is False
        keep R."""
        dtype = R.dtype
        ohf, af = oh.to(dtype), act_new.to(dtype)
        Gcol = ohf @ self.Gsr.T
        vcol = af * (1.0 - ohf) * Gcol
        Re, Rv = _bmv(R, ohf), _bmv(R, vcol)
        R_new = woodbury_rank2(R, Re, Rv, vcol, (ohf * Re).sum(1), (ohf * Rv).sum(1),
                               (ohf * Gcol).sum(1), torch.zeros_like(do))
        return torch.where(do[:, None, None], newton_schulz(self.Gsr, af, R_new, self.eye), R)

    def init(self, thetas) -> ChunkState:
        arr = self.arr
        dtype, dev = arr.G.dtype, arr.G.device
        self.thetas = thetas = torch.as_tensor(thetas, device=dev)
        B, m = thetas.shape[0], arr.G.shape[0]
        self.du_t, self.dl_t, self.U0, self.f_t = _theta_terms(arr, thetas)
        self.bidx = torch.arange(B, device=dev)
        act0 = arr.is_eq.expand(B, m).clone()
        cap = self.stack_cap
        if self.reference:
            R0 = torch.zeros((B, 1, 1), dtype=dtype, device=dev)
            stack_R = torch.zeros((B, 1, 1, 1), dtype=torch.float32, device=dev)
        else:
            R0 = self.seed_R(act0)
            stack_R = torch.zeros((B, cap, m, m), dtype=torch.float32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        zi = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
        return ChunkState(
            stack_fixed=zb(B, cap, m), stack_side=zb(B, cap, m),
            stack_lam=torch.zeros((B, cap, m), dtype=dtype, device=dev),
            stack_act=zb(B, cap, m),
            stack_ws=torch.ones((B, cap, m), dtype=torch.bool, device=dev),
            stack_bound=torch.full((B, cap), -BIG, dtype=dtype, device=dev),
            stack_R=stack_R, occ=zb(B, 1 if self.reference else cap),
            top=torch.zeros(B, dtype=torch.int64, device=dev),
            cur_fixed=zb(B, m), cur_fside=zb(B, m),
            lam=torch.zeros((B, m), dtype=dtype, device=dev), act=act0,
            side=torch.ones((B, m), dtype=torch.bool, device=dev), R=R0,
            node_iter=zi(), active_node=torch.ones(B, dtype=torch.bool, device=dev),
            inc_fval=torch.full((B,), BIG, dtype=dtype, device=dev),
            inc_lam=torch.zeros((B, m), dtype=dtype, device=dev),
            inc_active=zb(B, m), inc_side=zb(B, m), inc_found=zb(B),
            nodes=torch.ones(B, dtype=torch.int32, device=dev), iters=zi(),
            exhausted=zb(B), capped=zb(B), reseeds=zi())

    def step(self, s: ChunkState) -> tuple[ChunkState, torch.Tensor]:
        """One round: pop a node for idle lanes, at most ``K_CHUNK``
        relaxation iterations of every lane, then the management of the
        lanes whose node converged or failed. The stacks are updated in
        place. Returns the new state and ``any_active`` (a device bool)."""
        arr, big, bidx = self.arr, BIG, self.bidx
        dtype = arr.G.dtype
        du_t, dl_t = self.du_t, self.dl_t
        cap = s.stack_bound.shape[1]
        pos = lambda t: t.to(torch.int32)

        # ---- bound-prune the open nodes, then pop one for idle lanes
        if not self.reference:
            occ = s.occ & ~(s.inc_found[:, None] & (s.stack_bound >= s.inc_fval[:, None]))
            can_pop = ~s.active_node & occ.any(1) & (s.nodes < self.node_limit)
            # least bound once an incumbent prunes, deepest first before it
            # and while the open list nears capacity (deep subtrees drain
            # the slots soonest)
            margin = min(cap - 1, self.nb + 2)
            key_bound = torch.where(occ, s.stack_bound, big)
            key_depth = torch.where(occ, s.stack_fixed.sum(2), -1)
            room = occ.sum(1) < cap - margin
            pidx = torch.where(s.inc_found & room, key_bound.argmin(1), key_depth.argmax(1))
            occ[bidx, pidx] = occ[bidx, pidx] & ~can_pop
            top = occ.sum(1)
        else:
            occ = s.occ
            top = prune_tops(s.top, s.inc_found, s.inc_fval, s.stack_bound)
            can_pop = ~s.active_node & (top > 0) & (s.nodes < self.node_limit)
            pidx = (top - 1).clamp(min=0)
            top = top - can_pop.to(top.dtype)
        pop_fixed, pop_fside = s.stack_fixed[bidx, pidx], s.stack_side[bidx, pidx]
        pop_act = s.stack_act[bidx, pidx]
        nodes = s.nodes + pos(can_pop)
        cp = can_pop[:, None]
        cur_fixed = torch.where(cp, pop_fixed, s.cur_fixed)
        cur_fside = torch.where(cp, pop_fside, s.cur_fside)
        eq_lane = arr.is_eq | cur_fixed
        lam = torch.where(cp, s.stack_lam[bidx, pidx], s.lam)
        act = torch.where(cp, pop_act | eq_lane, s.act)
        side = torch.where(cp, torch.where(pop_fixed, pop_fside, s.stack_ws[bidx, pidx]),
                           s.side)
        node_iter = torch.where(can_pop, 0, s.node_iter)
        active = s.active_node | can_pop
        R = s.R
        if not self.reference:
            # the popped entry holds the parent's inverse; the child's
            # working set adds the branched row
            R = torch.where(can_pop[:, None, None], s.stack_R[bidx, pidx].to(dtype), R)
            new_row = pop_fixed & ~pop_act
            R = self.wu_add(R, act, new_row, can_pop & new_row.any(1))

        # ---- at most K_CHUNK iterations of the active lanes (idle lanes
        # enter at the limit)
        d_f = torch.where(cur_fside, du_t, dl_t)
        du_n, dl_n = torch.where(cur_fixed, d_f, du_t), torch.where(cur_fixed, d_f, dl_t)
        it0 = torch.where(active, 0, self.K_CHUNK).to(torch.int32)
        kw = dict(max_iter=self.K_CHUNK, primal_tol=self.primal_tol, sign_tol=self.sign_tol,
                  iters0=it0)
        if not self.reference:
            st, R, stale = _active_set_loop_wu(arr, du_n, dl_n, eq_lane, arr.is_immutable, lam,
                                               act, side, R, stale_tol=self.STALE_TOL,
                                               ridge=self.ridge, **kw)
        else:
            st = _active_set_loop(arr, du_n, dl_n, lam, act, side,
                                  use_cholesky=self.use_cholesky, eq=eq_lane, **kw)
            stale = torch.zeros_like(active)
        stepped = (st.iters - it0).clamp(min=0)
        am = active[:, None]
        lam = torch.where(am, st.lam, lam)
        act = torch.where(am, st.active, act)
        side = torch.where(am, st.side, side)
        node_iter = node_iter + stepped
        iters = s.iters + torch.where(active, stepped, 0)
        done_k = active & st.done
        feas = _primal_feasible(arr, du_n, dl_n, lam, act, side, self.primal_tol)
        conv = done_k & feas
        # a converged but infeasible node is pruned as unconverged
        nfail_cap = active & ~st.done & (node_iter >= self.node_cap)
        nfail = (done_k & ~feas) | nfail_cap

        # ---- management of the converged nodes
        _U, fval = _objective(arr, self.U0, self.f_t, lam)
        pruned_conv = conv & s.inc_found & (fval >= s.inc_fval)
        c = lam @ arr.G.T
        slack_up = torch.where(arr.up_finite, du_t + c, big)
        slack_lo = torch.where(arr.lo_finite, -dl_t - c, big)
        frac = torch.where(self.branchable_rows & ~cur_fixed,
                           torch.minimum(slack_up, slack_lo), -big)
        jb = frac.argmax(1)
        integral = _take(frac, jb) <= BIN_TOL
        better = conv & integral & ~pruned_conv & (fval < s.inc_fval)
        bt = better[:, None]
        inc_fval = torch.where(better, fval, s.inc_fval)
        inc_lam = torch.where(bt, lam, s.inc_lam)
        inc_active = torch.where(bt, act | cur_fixed, s.inc_active)
        inc_side = torch.where(bt, torch.where(cur_fixed, cur_fside, side), s.inc_side)
        inc_found = s.inc_found | better

        # ---- branch: push the far child (parent-warm), continue the near
        # child in place
        branch = conv & ~pruned_conv & ~integral
        onehot = self.idx == jb[:, None]
        child_fixed = cur_fixed | onehot
        near_up = _take(slack_up, jb) <= _take(slack_lo, jb)
        nu = near_up[:, None]
        far_viable = torch.where(near_up, arr.lo_finite[jb], arr.up_finite[jb])
        if not self.reference:
            free = ~occ
            has_free = free.any(1)
            ix = free.to(torch.uint8).argmax(1)
            do_push = branch & far_viable & has_free
            push_capped = branch & far_viable & ~has_free
            occ[bidx, ix] = occ[bidx, ix] | do_push
        else:
            ix = top.clamp(max=cap - 1)
            do_push = branch & far_viable & (top < cap)
            push_capped = branch & far_viable & (top >= cap)
        top = top + do_push.to(top.dtype)
        dom = do_push[:, None]
        for stack, v in ((s.stack_fixed, child_fixed),
                         (s.stack_side, torch.where(onehot, ~nu, cur_fside)),
                         (s.stack_lam, lam), (s.stack_act, act),
                         (s.stack_ws, torch.where(onehot, ~nu, side))):
            stack[bidx, ix] = torch.where(dom, v, stack[bidx, ix])
        s.stack_bound[bidx, ix] = torch.where(do_push, fval, s.stack_bound[bidx, ix])
        if not self.reference:
            # the far child inherits the parent's inverse, kept in float32
            s.stack_R[bidx, ix] = torch.where(do_push[:, None, None], R.to(torch.float32),
                                              s.stack_R[bidx, ix])

        bm = branch[:, None] & onehot
        cur_fixed = torch.where(branch[:, None], child_fixed, cur_fixed)
        cur_fside = torch.where(bm, nu, cur_fside)
        # the near child's fixed row joins the working set at its bound
        add_row = bm & ~act
        act = act | bm
        side = torch.where(bm, nu, side)
        nodes = nodes + pos(branch)
        node_iter = torch.where(branch, 0, node_iter)
        finished = (conv & (integral | pruned_conv)) | nfail
        active = (active & ~finished) | branch
        exhausted = s.exhausted | nfail
        capped = s.capped | nfail_cap | push_capped
        reseeds = s.reseeds
        if not self.reference:
            R = self.wu_add(R, act, add_row, branch & add_row.any(1))
            # drift certificate: reseed the lanes whose carried inverse
            # degraded or that the loop's staleness gate froze
            M = masked_system(self.Gsr, act.to(dtype))
            err = (torch.bmm(M, R) - self.eye).abs().amax((1, 2))
            bad = active & (stale | (err > self.DRIFT_TOL))
            R = torch.where(bad[:, None, None], self.seed_R(act), R)
            reseeds = reseeds + pos(bad)

        new = ChunkState(s.stack_fixed, s.stack_side, s.stack_lam, s.stack_act, s.stack_ws,
                         s.stack_bound, s.stack_R, occ, top, cur_fixed, cur_fside, lam, act,
                         side, R, node_iter, active, inc_fval, inc_lam, inc_active, inc_side,
                         inc_found, nodes, iters, exhausted, capped, reseeds)
        return new, (active | ((top > 0) & (nodes < self.node_limit))).any()

    def finish(self, s: ChunkState) -> Solution:
        """Statuses and the float64 re-solve of each incumbent's working set:
        1 proven optimal, 2 an exact incumbent of a budget-limited search
        (a node at its cap, the node limit, a full stack), -1 / -2 without
        an incumbent (a pruned unconverged or infeasible node / none)."""
        budgeted = s.capped | (s.nodes >= self.node_limit)
        status = _status(s.inc_found, budgeted, s.exhausted | budgeted)
        hi = self.arr if self.arr_hi is None else self.arr_hi
        sol = polish_solution(hi, self.thetas, s.inc_active, s.inc_side,
                              use_cholesky=self.use_cholesky)
        return _result(sol, s.inc_found, s.inc_active, s.inc_side, s.iters, status)

    def solve(self, thetas, max_rounds: int | None = None) -> Solution:
        """Rounds until no lane searches (checked every ``POLL_EVERY``
        rounds) or ``max_rounds`` (default: every node at its cap) have run;
        ``last_state`` and ``rounds`` keep the search's statistics."""
        s = self.init(thetas)
        cap_rounds = max_rounds or (
            self.node_limit * ((self.node_cap + self.K_CHUNK - 1) // self.K_CHUNK) + 8)
        r = 0
        while r < cap_rounds:
            n = min(self.POLL_EVERY, cap_rounds - r)
            for _ in range(n):
                s, any_active = self.step(s)
            r += n
            if not bool(any_active):
                break
        self.last_state, self.rounds = s, r
        return self.finish(s)


def refined_polish(arr: LDPArrays, hi: LDPArrays, thetas, act, side,
                   refine: int = 12) -> Solution:
    """Batched working-set re-solve: the float32 masked inverse as the
    preconditioner of a float64 Richardson iteration (``bnb_frontier.py:
    788-818``). Status 1 where the relative working-set residual is within
    1e-6, -1 where the Richardson stalled (an ill-conditioned incumbent set
    is not reported optimal)."""
    R = iu.init_R_batch(arr.G_solve, act)
    th64 = thetas.to(torch.float64)
    dt = th64 @ hi.Dth.T
    du_h, dl_h = hi.du + dt, hi.dl + dt
    actf = act.to(torch.float64)
    rhs = -actf * torch.where(side, du_h, dl_h)

    def apply_R(v):
        return torch.bmm(R, v.to(torch.float32)[:, :, None])[:, :, 0].to(torch.float64)

    def mask_apply(v):
        return actf * ((v * actf) @ hi.G_solve.T) + (1.0 - actf) * v

    lam = apply_R(rhs)
    for _ in range(refine):
        lam = lam + apply_R(rhs - mask_apply(lam))
    U, fval = _objective(hi, hi.u_off + th64 @ hi.Uth_off.T, hi.f + th64 @ hi.f_theta.T, lam)
    sys_res = (mask_apply(lam) - rhs).abs().amax(1)
    ok = sys_res <= 1e-6 * (1.0 + rhs.abs().amax(1))
    B = thetas.shape[0]
    one = torch.ones(B, dtype=torch.int32, device=ok.device)
    return Solution(U, lam, act, side, fval, torch.zeros_like(one), torch.where(ok, one, -one))

