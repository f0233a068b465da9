"""Solver engine: the device arrays and solve paths of one LDP.

Port of ``linearmpc_tpu/ops/engine.py`` (``:22-110``, the large-m tiers
``:112-1059``, the small-m tier ``:1061-1243`` and the entry points
``:1426-1501``). ``route`` picks the path from dtype, m, symmetry, binary
rows and the hierarchy: a float32 engine the JAX engine's route on its
accelerator, a float64 engine the exact CPU route, on either device:

* **float64** is the exact path: ``dual_active_set.solve_single`` without
  the continuation, on K1's float64 instantiation at m <= 10 on CUDA, the
  subset-table gather (m <= 12) or a masked factorization otherwise, as
  the JAX engine runs on the CPU.
* **float32, m = 0, m = 11-12, or a non-symmetric H above m = 10**
  ("single"): batched ``solve_single`` with its float64 continuation, as
  the JAX engine's XLA fallback (``engine.py:1498-1501``); m = 0 is the
  closed form with status 1. (The JAX float32 engine cannot be built at
  m = 0: ``engine.py:131-133`` divides by m^2.)
* **float32, m <= 10**, the small-m tier (any H): K1 bulk phase (``ops/bulk.py``)
  -> K2 polish (``ops/polish.py``) -> ``torch.topk`` of the K=256 worst
  lanes by ``bad`` -> ``finish_from_state`` in float64 -> merge and status
  (``engine.py:1136-1211``); ``fused_rollout_solve`` is its warm step, with
  a float64 finish of the lanes that fail its status rule.
* **float32, m > 12 where K3's routing rule admits m** (``iu_max_chunk_lanes
  (m) >= 128``, m <= 52), the IU tier (``engine.py:227-348``): K3 bulk
  phase (``ops/iu.py``) carrying the masked inverse R, float64 Richardson
  through R, the KKT residual ``bad``, two top-k straggler pools and a
  cold float64 re-solve of the stragglers on K3's float64 instantiation;
  ``fused_rollout_solve_iu`` is its warm step with the carried R.
* **float32, larger m**, the compact tier (``engine.py:553-939``): K4
  bulk phase (``ops/ciu.py``) over ``ciu_s_max`` working-set slots,
  Richardson through the slots, a second-chance K4 pass at ``s2`` slots
  for the 128 worst lanes, the float64 guard at doubled capacity and an
  escalating guard ladder, all on K4's float64 instantiation;
  ``fused_rollout_solve_ciu`` is its warm step with the carried slots.

Two kinds of problem take other paths, in this order (``engine.py:
1426-1475``):

* **a lexicographic hierarchy** (``lexicographic=True``): ``hierarchy.
  LexSolver``, one float64 solve per priority level whatever the engine's
  dtype and device, on K1's float64 instantiation on CUDA at m <= 10;
* **binary rows** (``has_binaries=True``), branch-and-bound
  (``engine.py:1245-1397``): in float32 the incremental node frontier
  (``bnb_frontier.IncFrontier``: on CUDA one launch of K3's search entry,
  on the CPU rounds of K3's resumable step), where the frontier's routing
  rule ``iu_max_chunk_lanes(m, 20 MiB) >= 128`` admits m (m <= 66), and
  beyond it the frontier rounds (``bnb_frontier.FrontierRounds``) on the
  float64 node arrays; in float64 the pop-per-round frontier with the GI
  relax for m <= 64 and the masked-Cholesky relax above. Single solves
  outside the incremental frontier, and a non-symmetric H, take the
  per-lane depth-first search (``bnb.solve_bnb_dfs``), whose incumbents a
  float32 engine re-solves in float64.

A (dp, mp) device mesh attached with ``attach_mesh`` sends batched solves of
a problem with more than 512 rows (or any, when forced) to the row-sharded
conjugate-gradient solver of ``parallel/schur.py`` (``engine.py:1402-1423``).

Single solves (``solve``) go through ``solve_single`` at B = 1 as the JAX
engine's do, so a float32 single solve reports -3 for an infeasible point.
Each tier is one piece of code: on CUDA tensors it launches the kernels,
on CPU tensors it runs their plain versions. The tiers' float32 matrix
products run at full precision (``full_f32``), as the JAX package's
``Precision.HIGHEST``. On CUDA the default dtype is float32. The JAX
package's environment switches (``LINEARMPC_TPU_PALLAS``,
``LINEARMPC_TPU_CIU_SMAX``, ``LINEARMPC_TPU_BNB_K``, ...) are not ported:
branch-and-bound runs with their defaults (8 iterations a round, mid-solve
pruning and root warm starts on; 24 a round and a poll every 4 rounds in
the frontier rounds). No lane chunking and no B % 128 rule or padding: the
kernels take any batch size.

Deliberate differences from the JAX package: the small-m tier reports
status 1 or -1 only (``engine.py:1209-1210``); its warm rollout step
finishes the lanes that fail its status rule, up to ``STRAGGLER_K`` a step,
on K1's float64 instantiation and K2, as the cold tier finishes its
stragglers, where the JAX rollout step leaves them at -1
(``engine.py:1218-1241``); K4 breaks ties between
equal dual step lengths by row, as the Pallas kernel does, also where the
JAX package runs its XLA compact loop (warm solves, the f64 guards); a
float64 re-solve (the IU tier's, the compact guard and ladder) whose
multipliers are not finite is unresolved (-1) whatever it flagged, where
the JAX package would take its -3 with NaN controls.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..profiling import count, span
from . import bulk, ciu, iu, polish, roll_finish
from .bnb import solve_bnb_dfs
from .bnb_frontier import FrontierRounds, IncFrontier, make_xla_relax, solve_bnb_frontier
from .dual_active_set import (
    LDPArrays,
    Solution,
    continue_from_state,
    finish_from_state,
    polish_solution,
    solve_single,
    to_device_arrays,
)
from .hierarchy import LexSolver
from .ldp import SUBSET_CACHE_MAX_M, LDPData, precompute_subset_inverses

STRAGGLER_K = 256   # lanes routed through the float64 continuation, and
                    # the most a rollout step's finish takes (without it a
                    # step of invpend-montecarlo left at most 16 at -1)
STRAGGLER_ITERS = 24
FIX_TOL = 1e-8      # residual above which a lane is re-solved in float64
ROLLOUT_TOL = 1e-5  # residual bound of a small-m rollout step's status
REFINE = 6          # Richardson steps of the IU tier (engine.py:129)
REFINE_ROLL = 4     # ... of its rollout step (:353)
REFINE_C = 4        # ... of the compact tier (:488)
REFINE_CR = 5       # ... of its rollout step (:945)
ROLL_RES = 1e-6     # relative system residual of a large-m rollout step
K_ROUND = 8         # GI iterations a round of the incremental frontier (engine.py:1304)


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def resolve_device(device) -> torch.device:
    """``device`` where the caller names one, else the card. Without CUDA
    and no device named this raises: nothing falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: the port runs on the card by default; '
                           'pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def route(device_type: str, dtype, m: int, *, symmetric: bool = True, binaries: bool = False,
          lexicographic: bool = False) -> tuple[str, str | None]:
    """(path, bnb_mode) of an engine, as the JAX engine picks them: a
    float32 engine takes the JAX engine's accelerator route, a float64
    engine the exact CPU route; the route is the same on ``"cpu"`` and
    ``"cuda"`` (``engine.py:86-120``, ``:1070-1077``, ``:1276-1397``).

    path: "lex"; "hybrid" with bnb_mode "dfs" (a non-symmetric H),
    "frontier" (float64), "inc" (float32 where K3's frontier rule admits
    m) or "rounds" (float32 beyond it); "exact" (float64); and in float32
    "small" (0 < m <= 10, any H), "single" (batched ``solve_single``: m = 0,
    m = 11-12, or a non-symmetric H above m = 10), "iu" (K3's rule admits
    m) or "compact"."""
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"the engine runs on cpu or cuda, got {device_type!r}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if lexicographic:
        return "lex", None
    f32 = dtype == torch.float32
    if binaries:
        if not symmetric:
            return "hybrid", "dfs"
        if not f32:
            return "hybrid", "frontier"
        admitted = iu.iu_max_chunk_lanes(m, iu.FRONTIER_BUDGET) >= iu.LANES
        return "hybrid", "inc" if admitted else "rounds"
    if not f32:
        return "exact", None
    if 0 < m <= bulk.MAX_M:
        return "small", None
    if m <= SUBSET_CACHE_MAX_M or not symmetric:
        return "single", None
    return ("iu" if iu.iu_max_chunk_lanes(m) >= iu.LANES else "compact"), None


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products at full precision (no TF32) inside the
    block, as the JAX package's ``Precision.HIGHEST``; restores the
    process's settings after."""
    prev = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


def top_k(x, k: int):
    """(values, indices) of the k largest entries of a (B,) tensor, ties in
    index order (the rule of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _mv(M, v):
    """Batched (B, n, n) @ (B, n)."""
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _scatter_rows(y, slots, m):
    """Slot-space (B, s) values to row space (B, m), zeros elsewhere."""
    dump = torch.where(slots >= 0, slots, m)  # free slots land in a dropped column
    out = torch.zeros((y.shape[0], m + 1), dtype=y.dtype, device=y.device)
    return out.scatter(1, dump, y)[:, :m]


class SolverEngine:
    def __init__(
        self,
        ldp: LDPData,
        *,
        device=None,
        dtype=None,
        iter_limit: int = 1000,
        primal_tol: float = 1e-6,
        sign_tol: float = 1e-12,
        has_binaries: bool = False,
        bnb_node_limit: int = 4096,
        symmetric: bool = True,
        lexicographic: bool = False,
        soft_weight: float = 1e6,
    ):
        self.ldp = ldp
        self._mp_solver = None  # the mp-Schur solver, once attach_mesh routes to it
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        m = ldp.m
        self.path, self.bnb_mode = route(self.device.type, self.dtype, m, symmetric=symmetric,
                                         binaries=has_binaries, lexicographic=lexicographic)
        self.tier = self.dtype == torch.float32
        self.iter_limit = int(iter_limit)
        self.symmetric = bool(symmetric)
        self.has_binaries = bool(has_binaries)
        self.bnb_node_limit = int(bnb_node_limit)
        # the sequential lexicographic hierarchy takes over every solve, in
        # float64 on the engine's device (engine.py:44-53)
        self.lex = None
        if lexicographic:
            self.lex = LexSolver(ldp, device=self.device, soft_weight=soft_weight,
                                 iter_limit=iter_limit, primal_tol=primal_tol,
                                 sign_tol=max(sign_tol, 1e-11))
            self.primal_tol, self.sign_tol = self.lex.primal_tol, self.lex.sign_tol
            self.arrays, self.arrays_hi = self.lex.base, None
            return

        subset_inv = None
        if 0 < m <= SUBSET_CACHE_MAX_M:
            subset_inv = precompute_subset_inverses(ldp)
        self._subset_inv = subset_inv
        # tolerances must sit above the iteration dtype's noise floor or
        # marginal multipliers flip sign forever; the f64 tiers restore
        # full accuracy afterwards (engine.py:68-70)
        if self.tier:
            primal_tol = max(primal_tol, 2e-5)
            sign_tol = max(sign_tol, 1e-6)
        self.primal_tol = float(primal_tol)
        self.sign_tol = float(sign_tol)
        self.arrays: LDPArrays = to_device_arrays(ldp, self.dtype, self.device, subset_inv)
        self.arrays_hi = (to_device_arrays(ldp, torch.float64, self.device, subset_inv)
                          if self.tier else None)
        # solve_single's keywords, for single solves and the "single" and
        # "exact" paths: the float32 bulk phase is the GI inverse-update
        # loop beyond the subset cache (engine.py:86-96)
        self._single_kw = dict(
            max_iter=self.iter_limit, primal_tol=self.primal_tol, sign_tol=self.sign_tol,
            use_cholesky=self.symmetric, arr_hi=self.arrays_hi,
            bulk_inverse_updates=(subset_inv is None and self.symmetric and self.tier
                                  and m <= 512))
        if self.has_binaries:
            self._init_hybrid()
            return
        if self.path in ("exact", "single"):
            return
        # kernel-side flags stay on the host: no device sync per launch
        self._eq = self.arrays.is_eq_host
        self._immut = self.arrays.is_immutable_host
        self._has_eq = bool(self._eq.any())
        if self.path == "small":
            self._pd = polish.make_polish_data(ldp, subset_inv, self.device)
            one = torch.ones((), dtype=torch.int32, device=self.device)
            self._plus_minus_one = (one, -one)
            self.bulk_cap = min(self.iter_limit, 2 * m + 20)
            return
        # the GI kernels' Gram matrices: f32 as the Pallas kernels build
        # them, f64 as the XLA loops do (ops/iu.py::gram)
        self._G32, self._Gs32 = iu.gram(ldp, torch.float32, self.device)
        self._G64, self._Gs64 = iu.gram(ldp, torch.float64, self.device)
        self.bulk_cap = min(self.iter_limit, 2 * m + 24)
        self._fix_ptol = min(self.primal_tol, 1e-6)
        if self.path == "compact":
            s_max, s2 = ciu.slot_capacities(m, ldp.n, int(self._eq.sum()))
            self.ciu_s_max, self._ciu_s2 = s_max, s2
            # K4 capped just above the generic working-set depth; the
            # second chance and the guards finish the rest (engine.py:549)
            self.bulk_cap_p = min(self.bulk_cap, max(26, 2 * ldp.n + 10))
            self.stats: dict[str, int] = {}

    def _init_hybrid(self):
        """Branch-and-bound set-up (engine.py:1245-1397): the stack holds a
        depth-first path (2 nb + 2 nodes), a node relaxation gets 2 m + 24
        iterations. ``bnb_mode`` (``route``): "inc" (float32, the incremental
        frontier: K3's search entry on CUDA, K3's resumable step in rounds on
        the CPU), "rounds" (float32 beyond K3's frontier rule,
        ``FrontierRounds`` on the float64 node arrays),
        "frontier" (float64, pop-per-round with the GI relax at m <= 64 and
        the masked-Cholesky relax above) or "dfs" (a non-symmetric H, the
        per-lane depth-first search)."""
        ldp, m = self.ldp, self.ldp.m
        nb = int(np.sum(ldp.is_binary))
        self.stack_cap = max(2 * nb + 2, 4)
        self.node_cap = min(self.iter_limit, 2 * m + 24)
        if self.bnb_mode == "inc":
            self._G32, self._Gs32 = iu.gram(ldp, torch.float32, self.device)
            self._stepper = iu.make_iu_stepper(
                self._G32, self._Gs32, self.arrays.is_immutable, K=K_ROUND,
                primal_tol=self.primal_tol, sign_tol=self.sign_tol)
        elif self.bnb_mode == "rounds":
            # the JAX accelerator's arguments (engine.py:1328-1385): a larger
            # stack for best-first's open list, a node cap above the longer
            # Woodbury walks
            self._rounds = FrontierRounds(
                self.arrays_hi, self.arrays_hi,
                stack_cap=max(self.stack_cap, min(6 * nb + 2, 256)),
                node_limit=self.bnb_node_limit, node_cap=min(self.iter_limit, 2 * self.node_cap),
                primal_tol=min(self.primal_tol, 1e-6), sign_tol=1e-11,
                use_cholesky=self.symmetric)
        elif self.bnb_mode == "frontier":
            self._relax = make_xla_relax(self.arrays, max_iter=self.node_cap,
                                         mode="cholesky" if m > 64 else "iu",
                                         primal_tol=self.primal_tol, sign_tol=self.sign_tol)

    def inc_frontier(self) -> IncFrontier:
        """The float32 engine's incremental frontier (its rounds can be run
        one at a time)."""
        return IncFrontier(self.arrays, self.arrays_hi, self._stepper,
                           stack_cap=self.stack_cap, node_limit=self.bnb_node_limit,
                           node_cap=self.node_cap, use_cholesky=self.symmetric)

    def _hybrid_batch(self, thetas) -> Solution:
        if self.bnb_mode == "inc":
            return self.inc_frontier().solve(thetas)
        if self.bnb_mode == "rounds":
            return self._rounds.solve(thetas)
        if self.bnb_mode == "frontier":
            return solve_bnb_frontier(self.arrays, None, thetas, self._relax,
                                      stack_cap=self.stack_cap, node_limit=self.bnb_node_limit,
                                      use_cholesky=self.symmetric)
        return self._dfs(thetas)

    def _dfs(self, thetas) -> Solution:
        """The per-lane depth-first search in the engine's dtype; a float32
        engine then re-solves each incumbent's working set in float64
        (engine.py:1257-1264)."""
        sol = solve_bnb_dfs(self.arrays, thetas, stack_cap=self.stack_cap,
                            node_limit=self.bnb_node_limit, max_iter=self.iter_limit,
                            primal_tol=self.primal_tol, sign_tol=self.sign_tol,
                            use_cholesky=self.symmetric)
        if self.arrays_hi is None:
            return sol
        return polish_solution(self.arrays_hi, thetas, sol.active, sol.side,
                               use_cholesky=self.symmetric, iters=sol.iters, status=sol.status)

    # -- shared pieces ------------------------------------------------------
    def _bounds32(self, thetas):
        arr = self.arrays
        dt = thetas.to(torch.float32) @ arr.Dth.T
        return arr.du + dt, arr.dl + dt

    def _bounds64(self, th64):
        hi = self.arrays_hi
        dt = th64 @ hi.Dth.T
        return hi.du + dt, hi.dl + dt

    def _mask_apply(self, v, actf):
        """The masked working-set system applied to v, in float64."""
        return actf * ((v * actf) @ self.arrays_hi.G_solve.T) + (1.0 - actf) * v

    def _richardson(self, apply_R, act, side, du_h, dl_h, refine):
        """Float64 Richardson refinement of the working-set multipliers with
        a float32 preconditioner ``apply_R`` (engine.py:255-268); returns
        (lam, rhs, actf)."""
        actf = act.to(torch.float64)
        rhs = -actf * torch.where(side, du_h, dl_h)
        lam = apply_R(rhs)
        for _ in range(refine):
            lam = lam + apply_R(rhs - self._mask_apply(lam, actf))
        return lam, rhs, actf

    def _recover(self, th64, lam):
        hi = self.arrays_hi
        U = hi.u_off + th64 @ hi.Uth_off.T - lam @ hi.HinvET.T
        f_t = hi.f + th64 @ hi.f_theta.T
        fval = 0.5 * ((U @ hi.H.T) * U).sum(1) + (f_t * U).sum(1)
        return U, fval

    def _kkt_bad(self, lam, act, side, du_h, dl_h):
        """Float64 KKT residual per lane (engine.py:668-688): inactive-row
        primal violation, active-row sign violation and the working-set
        system residual. A lane whose Richardson diverged (NaN) gets +inf:
        it cannot be certified, and it must rank first for the f64 tiers
        (a NaN ranks by its sign bit in a sort, and fails every test)."""
        hi = self.arrays_hi
        ninf = -torch.inf
        c = lam @ hi.G.T
        inact = ~act & ~hi.is_immutable
        primal = torch.where(inact, torch.maximum(-(du_h + c), dl_h + c), ninf).amax(1)
        sgn = torch.where(act & ~hi.is_eq, torch.where(side, -lam, lam), ninf).amax(1)
        actf = act.to(torch.float64)
        rhs = -actf * torch.where(side, du_h, dl_h)
        sys_res = (self._mask_apply(lam, actf) - rhs).abs().amax(1)
        bad = torch.maximum(torch.maximum(primal, sgn), sys_res)
        return torch.where(torch.isnan(bad), torch.inf, bad)

    def _fix_solution(self, th64, idx, lam, act, side, iters, status) -> Solution:
        U, fval = self._recover(th64[idx], lam)
        return Solution(U, lam, act, side, fval, iters, status)

    @staticmethod
    def _merge(out: Solution, idx, fix: Solution) -> Solution:
        """``out`` with the lanes ``idx`` replaced by ``fix``."""
        fields = []
        for base, upd in zip(out, fix):
            base = base.clone()
            base[idx] = upd.to(base.dtype)
            fields.append(base)
        return Solution(*fields)

    def _pools(self, bad, infeas32, k_a, k_b):
        """Lanes the float64 tier re-solves (engine.py:292-300, :826-832):
        pool A, the k_a worst by ``bad`` among lanes f32 did not flag
        infeasible, where ``bad`` > FIX_TOL; pool B, k_b lanes led by the
        f32-flagged ones, every one of which the JAX tier re-solves (its
        bad_top is +inf for every pool-B entry)."""
        top_a, idx_a = top_k(torch.where(infeas32, -torch.inf, bad), k_a)
        _, idx_b = top_k(torch.where(infeas32, torch.inf, -torch.inf), k_b)
        return torch.unique(torch.cat([idx_a[top_a > FIX_TOL], idx_b]))

    # -- the small-m tier ---------------------------------------------------
    def _small_k1(self, thetas, lam0, act0, side0):
        """The float32 bounds and K1 from the entry state, counted: B lanes
        and K1's iterations (held, summed after the session)."""
        arr = self.arrays
        count("small.lanes", thetas.shape[0])
        with span("lmpc.small.k1"):
            du_t, dl_t = self._bounds32(thetas)
            out = bulk.phase1(
                arr.subset_inv, arr.G, du_t, dl_t, self._eq, self._immut, lam0, act0, side0,
                max_iter=self.bulk_cap, primal_tol=self.primal_tol, sign_tol=self.sign_tol)
        count("small.k1_iters", lambda it=out[3]: it.sum())
        return out

    def _tier_batch(self, thetas, warm=None) -> Solution:
        arr, hi = self.arrays, self.arrays_hi
        B, m = thetas.shape[0], self.ldp.m
        if warm is None:
            lam0 = torch.zeros((B, m), dtype=torch.float32, device=self.device)
            act0 = arr.is_eq.expand(B, m).contiguous()
            side0 = torch.ones((B, m), dtype=torch.bool, device=self.device)
        else:
            lam0, act0, side0 = (torch.as_tensor(w, device=self.device).contiguous()
                                 for w in warm)
        lam, act, side, iters, _done = self._small_k1(
            thetas, lam0.to(torch.float32), act0.to(torch.bool), side0.to(torch.bool))
        # tier 1: float64 re-solve of each lane's final working set
        with span("lmpc.small.polish"):
            U, lam_p, fval, bad = polish.polish(self._pd, thetas, act, side)
        # tier 2: the worst lanes by KKT residual go through the float64
        # continuation; only those above FIX_TOL take its result
        with span("lmpc.small.stragglers"):
            bad_top, idx = torch.topk(bad, min(STRAGGLER_K, B))
            fix = finish_from_state(hi, thetas[idx], lam[idx], act[idx], side[idx], iters[idx],
                                    max_iter=STRAGGLER_ITERS, use_cholesky=self.symmetric)
            needs_fix = bad_top > FIX_TOL

            def merge(base, upd):
                sel = needs_fix.reshape((-1,) + (1,) * (upd.dim() - 1))
                out = base.clone()
                out[idx] = torch.where(sel, upd, base[idx])
                return out

            one = torch.ones_like(iters)
            status = torch.where(bad <= FIX_TOL, one, -one)
            sol = Solution(merge(U, fix.U), merge(lam_p, fix.lam), merge(act, fix.active),
                           merge(side, fix.side), merge(fval, fix.fval),
                           merge(iters, fix.iters), merge(status, fix.status))
        count("small.stragglers_fixed", lambda nf=needs_fix: nf.sum())
        return sol

    @full_f32()
    def fused_rollout_solve(self, thetas, lam0, act0, side0):
        """Warm-started whole-batch step of the closed loop: K1 bulk phase
        from the previous step's state, then K2 polish, then the float64
        finish of the lanes that fail the status rule (``_roll_finish``).
        Returns (U, lam, act, side, iters, status) with float64 U and lam;
        status is 1 where the lane converged and its residual is at most
        ``ROLLOUT_TOL``."""
        act0 = act0 | self.arrays.is_eq if self._has_eq else act0.contiguous()
        lam, act, side, iters, done = self._small_k1(thetas, lam0.to(torch.float32), act0, side0)
        with span("lmpc.small.polish"):
            th64 = thetas.to(torch.float64)
            U, lam_p, _fval, bad = polish.polish(self._pd, th64, act, side)
            ok = done & (bad <= ROLLOUT_TOL)
            status = torch.where(ok, *self._plus_minus_one)
            self._roll_finish(th64, lam, act, side, iters, ok, U, lam_p, status)
        return U, lam_p, act, side, iters, status

    def _roll_finish(self, th64, lam, act, side, iters, ok, U, lam_p, status):
        """The float64 finish of a warm step, in place on its outputs: the
        first ``STRAGGLER_K`` lanes that fail the status rule ``ok`` (placed
        in slots without a host read, ``roll_finish.gather``) continue from
        K1's float32 final state for ``STRAGGLER_ITERS`` more iterations
        (``continue_from_state``, as the cold tier's ``finish_from_state``);
        K2 re-solves the working set each ends on, and the step's rule gives
        its status. Only the lanes that failed take the result; a lane the
        continuation cannot finish stays -1. Counts ``small.roll_fixed``,
        the lanes taken (a held tensor)."""
        idx, take, th_k, lam_k, act_k, side_k, iters_k = roll_finish.gather(
            ok, min(STRAGGLER_K, ok.shape[0]), th64, lam, act, side, iters)
        fin = continue_from_state(self.arrays_hi, th_k, lam_k, act_k, side_k, iters_k,
                                  max_iter=STRAGGLER_ITERS)
        U_f, lam_f, _fval, bad_f = polish.polish(self._pd, th_k, fin.active, fin.side)
        roll_finish.merge(idx, take, U_f, lam_f, fin.active, fin.side, fin.iters, fin.done,
                          bad_f, U, lam_p, act, side, iters, status, tol=ROLLOUT_TOL)
        count("small.roll_fixed", lambda t=take: t.sum())
        # the merge wrote the finish's iterations into K1's in place:
        # small.k1_iters counts K1's own
        count("small.k1_iters", lambda t=take, i0=iters_k, it=fin.iters: -((it - i0) * t).sum())

    # -- the IU tier (m up to ~52) -------------------------------------------
    def _status(self, infeas, ok):
        one = torch.ones(infeas.shape[0], dtype=torch.int32, device=self.device)
        return torch.where(infeas, -3 * one, torch.where(ok, one, -one))

    def _f64_status(self, infeas, ok, lam):
        """Status of a float64 re-solve: as ``_status``, but a lane whose
        multipliers are not finite is unresolved (-1) whatever it flagged. A
        verdict reached through an overflowed inverse certifies nothing; the
        compact tier's guard ladder retries such a lane at more capacity."""
        return torch.where(torch.isfinite(lam).all(1), self._status(infeas, ok), -1)

    def _iu_phase1(self, du_t, dl_t, lam0, act0, side0, R0, retry):
        return iu.phase1_iu(self._G32, self._Gs32, du_t, dl_t, self._eq, self._immut,
                            lam0, act0, side0, R0, max_iter=self.bulk_cap,
                            primal_tol=self.primal_tol, sign_tol=self.sign_tol,
                            retry_infeas=retry)

    def iu_R0_init(self, B: int):
        """The carried inverse of a cold start (engine.py:413-418): one (m, m)
        matrix viewed by all B lanes, which K3 reads once (batch stride 0)."""
        m = self.ldp.m
        if not self._has_eq:
            return torch.eye(m, dtype=torch.float32, device=self.device).expand(B, m, m)
        return iu.init_R_batch(self.arrays.G_solve, self.arrays.is_eq[None]).expand(B, m, m)

    def _iu_batch(self, thetas, warm=None) -> Solution:
        arr, hi = self.arrays, self.arrays_hi
        B, m = thetas.shape[0], self.ldp.m
        with span("lmpc.iu.k3"):
            du_t, dl_t = self._bounds32(thetas)
            if warm is None:
                # cold entry states are exact: a ray found from them stands
                lam0 = torch.zeros((B, m), dtype=torch.float32, device=self.device)
                act0 = arr.is_eq.expand(B, m)
                side0 = torch.ones((B, m), dtype=torch.bool, device=self.device)
                R0 = self.iu_R0_init(B)
            else:
                lam0, act0, side0 = (torch.as_tensor(w, device=self.device) for w in warm)
                act0 = act0.to(torch.bool) | arr.is_eq
                R0 = iu.init_R_batch(arr.G_solve, act0)
            lam32, act, side, iters, _done, infeas32, R = self._iu_phase1(
                du_t, dl_t, lam0.to(torch.float32), act0, side0.to(torch.bool), R0,
                retry=warm is not None)

        with span("lmpc.iu.refine"):
            th64 = thetas.to(torch.float64)
            du_h, dl_h = self._bounds64(th64)
            lam, _, _ = self._richardson(lambda v: _mv(R, v.to(torch.float32)).double(),
                                         act, side, du_h, dl_h, REFINE)
            bad = self._kkt_bad(lam, act, side, du_h, dl_h)
            U, fval = self._recover(th64, lam)
            out = Solution(U, lam, act, side, fval, iters,
                           self._status(infeas32, bad <= FIX_TOL))

        # stragglers: a cold float64 re-solve with the same GI iteration
        # (cold on purpose, engine.py:301-309), on K3's float64 instantiation
        with span("lmpc.iu.pools"):
            k = min(max(128, B // 64), B)
            idx = self._pools(bad, infeas32, k, k)
            n = idx.numel()
        count("iu.resolve_lanes", n)
        if n == 0:
            return out
        # the pooled lanes that float32 left uncertified (status -3 or -1)
        count("iu.resolve_needed", lambda st=out.status, i=idx: (st[i] != 1).sum())
        with span("lmpc.iu.resolve64"):
            act_c = hi.is_eq.expand(n, m)
            lam_f, act_f, side_f, it_f, done_f, inf_f, _R = iu.phase1_iu(
                self._G64, self._Gs64, du_h[idx], dl_h[idx], self._eq, self._immut,
                torch.zeros((n, m), dtype=torch.float64, device=self.device), act_c,
                torch.ones((n, m), dtype=torch.bool, device=self.device),
                iu.init_R_batch(hi.G_solve, hi.is_eq[None])[0], max_iter=self.bulk_cap + 24,
                primal_tol=self._fix_ptol, sign_tol=1e-11)
            fix = self._fix_solution(th64, idx, lam_f, act_f, side_f, iters[idx] + it_f,
                                     self._f64_status(inf_f, done_f, lam_f))
            return self._merge(out, idx, fix)

    @full_f32()
    def fused_rollout_solve_iu(self, thetas, lam0, act0, side0, R0):
        """Warm-started IU step of the closed loop (engine.py:355-410): K3
        from the previous step's multipliers, working set and carried R,
        with the warm-ray retry; one Newton-Schulz pass on R; a short f64
        Richardson. Returns (U f32, lam f32, act, side, iters, status, R).
        On the card everything after K3 is one launch of ``iu_epilogue``;
        on the CPU it is ``_rollout_epilogue_plain``."""
        arr = self.arrays
        with span("lmpc.iu.k3"):
            du_t, dl_t = self._bounds32(thetas)
            lam32, act, side, iters, done, infeas32, R = self._iu_phase1(
                du_t, dl_t, lam0.to(torch.float32), act0 | arr.is_eq, side0, R0, retry=True)
        epilogue = (self._rollout_epilogue_cuda if R.device.type == "cuda"
                    else self._rollout_epilogue_plain)
        U, lam, status, R = epilogue(thetas, act, side, done, infeas32, R)
        return U, lam, act, side, iters, status, R

    def _rollout_epilogue_plain(self, thetas, act, side, done, infeas32, R):
        """Everything the warm IU step does after K3, in torch: (U f32, lam
        f32, status, R)."""
        arr = self.arrays
        m = self.ldp.m
        # one Newton-Schulz pass keeps the carried inverse from drifting
        with span("lmpc.iu.newton_schulz"):
            actf = act.to(torch.float32)
            eye = torch.eye(m, dtype=torch.float32, device=self.device)
            Gs = arr.G_solve + 4.0 * float(np.finfo(np.float32).eps) * eye
            M = Gs * actf[:, :, None] * actf[:, None, :] + torch.diag_embed(1.0 - actf)
            R = torch.bmm(R, 2.0 * eye - torch.bmm(M, R))

        with span("lmpc.iu.refine"):
            th64 = thetas.to(torch.float64)
            du_h, dl_h = self._bounds64(th64)
            lam, rhs, actf64 = self._richardson(lambda v: _mv(R, v.to(torch.float32)).double(),
                                                act, side, du_h, dl_h, REFINE_ROLL)
            U, _ = self._recover(th64, lam)
            status = self._status(infeas32, done & self._resolved(lam, rhs, actf64))
        return U.float(), lam.float(), status, R

    def _rollout_epilogue_cuda(self, thetas, act, side, done, infeas32, R):
        """The same on the card, one launch of ``iu_epilogue`` with the
        statics it reads made once an engine."""
        from . import iu_epilogue  # the rollout step alone loads the kernel

        if getattr(self, "_epilogue_statics", None) is None:
            arr, hi, m = self.arrays, self.arrays_hi, self.ldp.m
            eye = torch.eye(m, dtype=torch.float32, device=self.device)
            Gs = arr.G_solve + 4.0 * float(np.finfo(np.float32).eps) * eye
            statics = (Gs, hi.G_solve, hi.Dth, hi.du, hi.dl, hi.u_off, hi.Uth_off, hi.HinvET)
            self._epilogue_statics = tuple(t.contiguous() for t in statics)
        count("iu.epilogue_lanes", thetas.shape[0])
        with span("lmpc.iu.epilogue"):
            return iu_epilogue.epilogue(*self._epilogue_statics, thetas, R, act, side, done,
                                        infeas32, refine=REFINE_ROLL, res_tol=ROLL_RES)

    def _resolved(self, lam, rhs, actf):
        """Relative working-set residual within ROLL_RES (engine.py:400-408)."""
        sys_res = (self._mask_apply(lam, actf) - rhs).abs().amax(1)
        return sys_res <= ROLL_RES * (1.0 + rhs.abs().amax(1))

    # -- the compact tier -------------------------------------------------------
    def _apply_slots(self, slots, Rw, act):
        """The compact preconditioner: Rw on the working-set slots, identity
        on inactive rows, float32 in and float64 out (engine.py:648-653)."""
        m = self.ldp.m
        occ = slots >= 0
        sl = slots.clamp_min(0)
        inact = 1.0 - act.to(torch.float32)

        def apply(v):
            v32 = v.to(torch.float32)
            y = _mv(Rw, torch.where(occ, v32.gather(1, sl), 0.0))
            return (_scatter_rows(y, slots, m) + v32 * inact).double()

        return apply

    def _rich_sel(self, slots, Rw, act, side, du_h, dl_h, th64, refine=REFINE_C):
        """Float64 Richardson through the slot preconditioner; returns (lam,
        U, fval) (engine.py:641-666)."""
        lam, _, _ = self._richardson(self._apply_slots(slots, Rw, act),
                                     act, side, du_h, dl_h, refine)
        U, fval = self._recover(th64, lam)
        return lam, U, fval

    def _ciu_f64(self, du_h, dl_h, s, cap):
        """Cold float64 compact re-solve at ``s`` slots on K4's float64
        instantiation (the XLA guard loops of engine.py:843-850, :899-908)."""
        hi = self.arrays_hi
        n, m = du_h.shape
        act_c = hi.is_eq.expand(n, m)
        Rw0, sl0, _ = ciu.init_compact_batch(hi.G_solve, hi.is_eq[None], s)
        return ciu.phase1_ciu(
            self._G64, self._Gs64, du_h, dl_h, self._eq, self._immut,
            torch.zeros((n, m), dtype=torch.float64, device=self.device), act_c,
            torch.ones((n, m), dtype=torch.bool, device=self.device), sl0.expand(n, s), Rw0[0],
            max_iter=cap, primal_tol=self._fix_ptol, sign_tol=1e-11)

    def _ciu_cold_carry(self, B):
        """The slot carry of a cold batch: one slot map and one (s, s) Rw for
        the equality rows, viewed by all B lanes (K4 reads Rw once)."""
        s = self.ciu_s_max
        if self._has_eq:
            Rw0, sl0, _ = ciu.init_compact_batch(self.arrays.G_solve, self.arrays.is_eq[None], s)
            return sl0.expand(B, s), Rw0.expand(B, s, s)
        return self.ciu_carry_init(B)

    def ciu_carry_init(self, B: int):
        """The slot carry of a cold rollout start: every slot free, Rw = I
        viewed by all B lanes (engine.py:1056-1059)."""
        s = self.ciu_s_max
        return (torch.full((B, s), -1, dtype=torch.int64, device=self.device),
                torch.eye(s, dtype=torch.float32, device=self.device).expand(B, s, s))

    def _ciu_phase1(self, du_t, dl_t, lam0, act0, side0, slots0, Rw0, cap, retry):
        return ciu.phase1_ciu(self._G32, self._Gs32, du_t, dl_t, self._eq, self._immut,
                              lam0.to(torch.float32), act0, side0, slots0, Rw0,
                              max_iter=cap, primal_tol=self.primal_tol,
                              sign_tol=self.sign_tol, retry_infeas=retry)

    def _ciu_batch(self, thetas, warm=None) -> Solution:
        arr = self.arrays
        B, m = thetas.shape[0], self.ldp.m
        du_t, dl_t = self._bounds32(thetas)
        # the second chance runs behind a cold bulk phase where the JAX
        # package's Pallas kernel is eligible; a warm start (its XLA loop
        # there) runs the full cap and the wide guard pools
        second = warm is None and self._ciu_s2 is not None
        if warm is None:
            lam0 = torch.zeros((B, m), dtype=torch.float32, device=self.device)
            act0 = arr.is_eq.expand(B, m)
            side0 = torch.ones((B, m), dtype=torch.bool, device=self.device)
            slots0, Rw0 = self._ciu_cold_carry(B)
        else:
            lam0, act0, side0 = (torch.as_tensor(w, device=self.device) for w in warm)
            act0 = act0.to(torch.bool) | arr.is_eq
            Rw0, slots0, _ = ciu.init_compact_batch(arr.G_solve, act0, self.ciu_s_max)
        cap = self.bulk_cap_p if second else self.bulk_cap
        lam32, act, side, iters, _done, infeas32, ovf, slots, Rw = self._ciu_phase1(
            du_t, dl_t, lam0, act0, side0.to(torch.bool), slots0, Rw0, cap, retry=False)

        th64 = thetas.to(torch.float64)
        du_h, dl_h = self._bounds64(th64)
        lam, U, fval = self._rich_sel(slots, Rw, act, side, du_h, dl_h, th64)
        # capacity-overflow lanes cannot be certified by their carry
        bad = torch.where(ovf, torch.inf, self._kkt_bad(lam, act, side, du_h, dl_h))
        stats = dict(second_chance=0, second_taken=0, guard=0, ladder=0)
        if second:
            lam, U, fval, act, side, iters, bad, taken = self._second_chance(
                du_t, dl_t, du_h, dl_h, th64, lam32, lam, U, fval, act, side, iters,
                bad, infeas32)
            stats.update(second_chance=min(B, 128), second_taken=taken)
        out = Solution(U, lam, act, side, fval, iters,
                       self._status(infeas32, bad <= FIX_TOL))

        # the f64 guard at doubled capacity, cold (engine.py:833-841)
        k_a = min(64, B) if second else min(max(256, B // 32), B)
        k_b = min(32, B) if second else min(max(128, B // 64), B)
        idx = self._pools(bad, infeas32, k_a, k_b)
        if idx.numel():
            s2g = min(m, ciu.up8(2 * self.ciu_s_max))
            lam_f, act_f, side_f, it_f, done_f, inf_f, ovf_f, _s, _R = self._ciu_f64(
                du_h[idx], dl_h[idx], s2g, self.bulk_cap + 24)
            out = self._merge(out, idx, self._fix_solution(
                th64, idx, lam_f, act_f, side_f, iters[idx] + it_f,
                self._f64_status(inf_f, done_f & ~ovf_f, lam_f)))
            stats["guard"] = idx.numel()
            # the escalating guard ladder for lanes still unresolved
            # (engine.py:877-938); a host-side check in place of lax.cond
            s3 = min(m, ciu.up8(3 * s2g))
            s4 = min(m, max(ciu.up8(2 * s3), 128))
            ladder = [(s3, 2 * self.bulk_cap + 48)] if s3 > s2g else []
            if s4 > s3:
                ladder.append((s4, 4 * self.bulk_cap + 96))
            for s_g, cap_g in ladder:
                unres = out.status == -1
                n_unres = int(unres.sum())
                if n_unres == 0:
                    break
                _, idx3 = top_k(torch.where(unres, bad, -torch.inf), min(16, n_unres))
                lam_g, act_g, side_g, it_g, done_g, inf_g, ovf_g, _s, _R = self._ciu_f64(
                    du_h[idx3], dl_h[idx3], s_g, cap_g)
                stats["ladder"] += idx3.numel()
                st3 = self._f64_status(inf_g, done_g & ~ovf_g, lam_g)
                take = unres[idx3] & (st3 != -1)
                if bool(take.any()):
                    idx3 = idx3[take]
                    out = self._merge(out, idx3, self._fix_solution(
                        th64, idx3, lam_g[take], act_g[take], side_g[take],
                        out.iters[idx3] + it_g[take], st3[take]))
        self.stats = stats
        return out

    def _second_chance(self, du_t, dl_t, du_h, dl_h, th64, lam32, lam, U, fval, act,
                       side, iters, bad, infeas32):
        """Warm-resume the 128 worst lanes through K4 at ``s2`` slots with a
        rebuilt carry; a lane takes the result only where its f64 KKT
        residual improves (engine.py:724-818)."""
        arr = self.arrays
        B, m = lam.shape
        s2 = self._ciu_s2
        cap2 = min(self.bulk_cap, max(160, 4 * self.bulk_cap_p))
        _, idx2 = top_k(torch.where(infeas32, -torch.inf, bad), min(B, 128))
        # rebuild the slot carry from each lane's working set; lanes whose
        # set exceeds s2 restart cold
        act_g = act[idx2]
        fits = (act_g.sum(1) <= s2)[:, None]
        act_g = torch.where(fits, act_g, arr.is_eq)
        lam_g = torch.where(fits, lam32[idx2], 0.0)
        side_g = torch.where(fits, side[idx2], True)
        Rw2, sl2, _ = ciu.init_compact_batch(arr.G_solve, act_g, s2)
        lam2_32, act2, side2, it2, _d, inf2, ovf2, sl2o, Rw2o = self._ciu_phase1(
            du_t[idx2], dl_t[idx2], lam_g, act_g, side_g, sl2, Rw2, cap2, retry=True)
        lam2, U2, fval2 = self._rich_sel(sl2o, Rw2o, act2, side2, du_h[idx2], dl_h[idx2],
                                         th64[idx2])
        # overflow at s2 and warm-derived ray flags are not certifiable
        bad2 = torch.where(ovf2 | inf2, torch.inf,
                           self._kkt_bad(lam2, act2, side2, du_h[idx2], dl_h[idx2]))
        take = bad2 < bad[idx2]

        def scat(base, upd):
            out = base.clone()
            sel = take.reshape((-1,) + (1,) * (upd.dim() - 1))
            out[idx2] = torch.where(sel, upd, base[idx2])
            return out

        iters = iters.clone()
        iters[idx2] += it2
        return (scat(lam, lam2), scat(U, U2), scat(fval, fval2), scat(act, act2),
                scat(side, side2), iters, scat(bad, bad2), int(take.sum()))

    @full_f32()
    def fused_rollout_solve_ciu(self, thetas, lam0, act0, side0, carry):
        """Warm-started compact step of the closed loop (engine.py:947-1053):
        K4 from the previous step's state and slot carry with the warm-ray
        retry; one Newton-Schulz pass on Rw; a short f64 Richardson; a lane
        that overflowed its slots restarts cold next step. Returns (U f32,
        lam, act, side, iters, status, (slots, Rw))."""
        arr = self.arrays
        m, s = self.ldp.m, self.ciu_s_max
        slots0, Rw0 = carry
        du_t, dl_t = self._bounds32(thetas)
        lam32, act, side, iters, done, infeas32, ovf, slots, Rw = self._ciu_phase1(
            du_t, dl_t, lam0, act0, side0, slots0, Rw0, self.bulk_cap, retry=True)
        # one Newton-Schulz pass on the slot inverse: Rw <- Rw (2I - Mw Rw)
        occ = slots >= 0
        sl = slots.clamp_min(0)
        eye_m = torch.eye(m, dtype=torch.float32, device=self.device)
        Gs = arr.G_solve + 4.0 * float(np.finfo(np.float32).eps) * eye_m
        occf = occ.to(torch.float32)
        Mw = (Gs[sl[:, :, None], sl[:, None, :]] * occf[:, :, None] * occf[:, None, :]
              + torch.diag_embed(1.0 - occf))
        eye_s = torch.eye(s, dtype=torch.float32, device=self.device)
        Rw = torch.bmm(Rw, 2.0 * eye_s - torch.bmm(Mw, Rw))

        th64 = thetas.to(torch.float64)
        du_h, dl_h = self._bounds64(th64)
        lam, rhs, actf = self._richardson(self._apply_slots(slots, Rw, act), act, side,
                                          du_h, dl_h, REFINE_CR)
        U, _ = self._recover(th64, lam)
        status = self._status(infeas32, done & ~ovf & self._resolved(lam, rhs, actf))
        # an overflowed lane's slot carry is unusable: reset it cold
        o = ovf[:, None]
        lam32 = torch.where(o, 0.0, lam32)
        act = act & ~o
        side = side | o
        slots = torch.where(o, -1, slots)
        Rw = torch.where(ovf[:, None, None], eye_s, Rw)
        return U.float(), lam32, act, side, iters, status, (slots, Rw)

    # -- model parallelism: batched solves through the mp-Schur row-sharded
    # solver (parallel/schur.py) once a mesh is attached and the row
    # dimension is past the single-device paths' reach (engine.py:1402-1423)
    def attach_mesh(self, mesh, *, mp_threshold: int = 512, force: bool = False, **schur_kw):
        """Configure a (dp, mp) ``DeviceMesh``. Batched solves dispatch to the
        row-sharded CG solver when ``ldp.m > mp_threshold`` (or ``force``);
        smaller problems keep the single-device paths. Raises for a hybrid
        engine: the mp-Schur solver has no branch-and-bound. Returns self."""
        self._mp_solver = None
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for an engine on {self.device}")
        if self.has_binaries:
            raise ValueError(
                "attach_mesh does not support hybrid (binary-constrained) "
                "problems: the mp-Schur solver has no branch-and-bound")
        if force or self.ldp.m > mp_threshold:
            from ..parallel.schur import make_mp_batch_solver

            self._mp_solver = make_mp_batch_solver(
                self.ldp, mesh, max_iter=min(self.iter_limit, 2 * self.ldp.m + 32),
                primal_tol=min(self.primal_tol, 1e-6), sign_tol=max(self.sign_tol, 1e-9),
                **schur_kw)
        return self

    # -- entry points -------------------------------------------------------
    @full_f32()
    def solve_batch(self, thetas, warm=None) -> Solution:
        """Batched solve of (B, n_theta) parameters; ``warm`` is an optional
        (lam0, act0, side0) warm start. The float32 tiers keep theta in
        float64 (only their bulk phase rounds it to float32)."""
        with span("lmpc.engine.solve_batch"):
            in_dtype = torch.float64 if self.tier else self.dtype
            thetas = torch.as_tensor(thetas, device=self.device).to(in_dtype)
            if self.lex is not None:
                return self.lex.solve_batch(thetas)
            if self._mp_solver is not None:
                return self._mp_solver(thetas)
            if self.path == "hybrid":
                return self._hybrid_batch(thetas)
            if self.path == "small":
                return self._tier_batch(thetas, warm)
            if self.path == "iu":
                return self._iu_batch(thetas, warm)
            if self.path == "compact":
                return self._ciu_batch(thetas, warm)
            # "exact" and "single": batched solve_single (engine.py:1498-1501)
            w = (None,) * 3 if warm is None else tuple(warm)
            return solve_single(self.arrays, thetas, *w, **self._single_kw)

    @full_f32()
    def solve(self, theta) -> tuple[np.ndarray, float, int, dict]:
        """Single solve (reference solve(), src/utils.jl:268-283), routed as
        the JAX engine routes it (engine.py:1426-1452): ``solve_single`` at
        B = 1 (in float32 with the float64 continuation, which reports -3
        for an infeasible point); a lexicographic engine through its levels;
        branch-and-bound by the depth-first search, except in the float32
        incremental frontier, which takes a batch of one. Returns (U, fval,
        status, info)."""
        with span("lmpc.engine.solve"):
            theta = torch.as_tensor(np.asarray(theta, dtype=np.float64).reshape(1, -1),
                                    device=self.device)
            if self.path == "hybrid" and self.bnb_mode != "inc":
                sol = self._dfs(theta)
            elif self.path in ("lex", "hybrid"):
                sol = self.solve_batch(theta)
            else:
                sol = solve_single(self.arrays, theta, **self._single_kw)
            with span("lmpc.engine.to_host"):
                info = {
                    "iterations": int(sol.iters[0]),
                    "lam": sol.lam[0].cpu().numpy(),
                    "active": sol.active[0].cpu().numpy(),
                    "side": sol.side[0].cpu().numpy(),
                }
                return (sol.U[0].cpu().numpy().astype(np.float64), float(sol.fval[0]),
                        int(sol.status[0]), info)
