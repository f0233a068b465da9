"""Solver engine: the device arrays and solve paths of one LDP.

Port of ``linearmpc_tpu/ops/engine.py`` (``:22-110``, the small-m tier
``:1061-1243`` and the entry points ``:1426-1501``). The engine picks its
path by dtype:

* **float64** is the exact path: ``dual_active_set.solve_batch`` with the
  subset-table gather (m <= 12) or a masked factorization, as the JAX
  engine runs on the CPU. It runs on the CPU only.
* **float32** with m <= 10 is the small-m tier: K1 bulk phase
  (``ops/bulk.py``) -> K2 polish (``ops/polish.py``) -> ``torch.topk`` of
  the K=256 worst lanes by ``bad`` -> ``finish_from_state`` in float64 ->
  merge and status (``engine.py:1136-1211``). ``fused_rollout_solve`` is
  the warm-started K1 + K2 step of the closed loop (``:1218-1241``). The
  tier is one piece of code: on CUDA tensors it launches the kernels, on
  CPU tensors it runs their plain versions.

On CUDA the default dtype is float32, and a configuration outside the tier
(float64, m > 10, binaries, lexicographic hierarchy, non-symmetric H)
raises ``NotImplementedError`` naming the ROADMAP item that ports it; it
does not run on the CPU instead. The JAX package's environment switches
(``LINEARMPC_TPU_PALLAS``, ``LINEARMPC_TPU_DS``, ...) are not ported. No
lane chunking and no B % 128 rule: the kernels take any batch size.

Deliberate difference from the JAX single solve: the tier reports status
1 or -1 only (``engine.py:1209-1210``), while the exact path's single and
batched solves also report -3 through ``_primal_feasible``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bulk, polish
from .dual_active_set import (
    LDPArrays,
    Solution,
    finish_from_state,
    solve_batch,
    to_device_arrays,
)
from .ldp import SUBSET_CACHE_MAX_M, LDPData, precompute_subset_inverses

STRAGGLER_K = 256   # lanes routed through the float64 continuation
STRAGGLER_ITERS = 24
FIX_TOL = 1e-8      # polish residual above which a lane is re-solved
ROLLOUT_TOL = 1e-5  # residual bound of a rollout step's status


def default_dtype(device) -> torch.dtype:
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to CUDA yet (ROADMAP.md, modules to port, {item})")


class SolverEngine:
    def __init__(
        self,
        ldp: LDPData,
        *,
        device="cpu",
        dtype=None,
        iter_limit: int = 1000,
        primal_tol: float = 1e-6,
        sign_tol: float = 1e-12,
        has_binaries: bool = False,
        symmetric: bool = True,
        lexicographic: bool = False,
    ):
        self.ldp = ldp
        self.device = torch.device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, got {self.dtype}")
        m = ldp.m
        on_cuda = self.device.type == "cuda"
        self.tier = self.dtype == torch.float32
        if has_binaries:
            _unsupported("hybrid (binary) MPC / branch-and-bound", "item 6")
        if lexicographic:
            _unsupported("the lexicographic hierarchy", "item 6")
        if on_cuda and not self.tier:
            _unsupported("the float64 exact path on CUDA", "item 5")
        if self.tier and not (0 < m <= bulk.MAX_M):
            _unsupported(f"the float32 tier at m={m} (the small-m tier takes "
                         f"1 <= m <= {bulk.MAX_M})", "item 5, large-m tiers")
        if self.tier and not symmetric:
            _unsupported("a non-symmetric H (AVI) in the float32 tier", "item 5")

        subset_inv = None
        if 0 < m <= SUBSET_CACHE_MAX_M:
            subset_inv = precompute_subset_inverses(ldp)
        self._subset_inv = subset_inv
        self.iter_limit = int(iter_limit)
        # tolerances must sit above the iteration dtype's noise floor or
        # marginal multipliers flip sign forever; the f64 tiers restore
        # full accuracy afterwards (engine.py:68-70)
        if self.tier:
            primal_tol = max(primal_tol, 2e-5)
            sign_tol = max(sign_tol, 1e-6)
        self.primal_tol = float(primal_tol)
        self.sign_tol = float(sign_tol)
        self.symmetric = bool(symmetric)
        self.arrays: LDPArrays = to_device_arrays(ldp, self.dtype, self.device, subset_inv)
        self.arrays_hi = (to_device_arrays(ldp, torch.float64, self.device, subset_inv)
                          if self.tier else None)
        if self.tier:
            self._pd = polish.make_polish_data(ldp, subset_inv, self.device)
            # kernel-side flags stay on the host: no device sync per launch
            self._eq = torch.as_tensor(np.asarray(ldp.is_eq, bool))
            self._immut = torch.as_tensor(np.asarray(ldp.is_immutable, bool))
            self.bulk_cap = min(self.iter_limit, 2 * m + 20)

    # -- the small-m tier -------------------------------------------------
    def _bounds32(self, thetas):
        arr = self.arrays
        dt = thetas.to(torch.float32) @ arr.Dth.T
        return arr.du + dt, arr.dl + dt

    def _tier_batch(self, thetas, warm=None) -> Solution:
        arr, hi = self.arrays, self.arrays_hi
        B, m = thetas.shape[0], self.ldp.m
        if warm is None:
            lam0 = torch.zeros((B, m), dtype=torch.float32, device=self.device)
            act0 = arr.is_eq.expand(B, m)
            side0 = torch.ones((B, m), dtype=torch.bool, device=self.device)
        else:
            lam0, act0, side0 = (torch.as_tensor(w, device=self.device) for w in warm)
        du_t, dl_t = self._bounds32(thetas)
        lam, act, side, iters, _done = bulk.phase1(
            arr.subset_inv, arr.G, du_t, dl_t, self._eq, self._immut,
            lam0.to(torch.float32), act0.to(torch.bool), side0.to(torch.bool),
            max_iter=self.bulk_cap, primal_tol=self.primal_tol, sign_tol=self.sign_tol)
        # tier 1: float64 re-solve of each lane's final working set
        U, lam_p, fval, bad = polish.polish(self._pd, thetas, act, side)
        # tier 2: the worst lanes by KKT residual go through the float64
        # continuation; only those above FIX_TOL take its result
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
        return Solution(merge(U, fix.U), merge(lam_p, fix.lam), merge(act, fix.active),
                        merge(side, fix.side), merge(fval, fix.fval),
                        merge(iters, fix.iters), merge(status, fix.status))

    def fused_rollout_solve(self, thetas, lam0, act0, side0):
        """Warm-started whole-batch step of the closed loop: K1 bulk phase
        from the previous step's state, then K2 polish, no straggler tier.
        Returns (U, lam, act, side, iters, status) with float64 U and lam;
        status is 1 where the lane converged and its residual is at most
        ``ROLLOUT_TOL``."""
        arr = self.arrays
        du_t, dl_t = self._bounds32(thetas)
        lam, act, side, iters, done = bulk.phase1(
            arr.subset_inv, arr.G, du_t, dl_t, self._eq, self._immut,
            lam0.to(torch.float32), act0 | arr.is_eq, side0,
            max_iter=self.bulk_cap, primal_tol=self.primal_tol, sign_tol=self.sign_tol)
        U, lam_p, _fval, bad = polish.polish(self._pd, thetas.to(torch.float64), act, side)
        one = torch.ones_like(iters)
        status = torch.where(done & (bad <= ROLLOUT_TOL), one, -one)
        return U, lam_p, act, side, iters, status

    # -- entry points -------------------------------------------------------
    def solve_batch(self, thetas, warm=None) -> Solution:
        """Batched solve of (B, n_theta) parameters; ``warm`` is an optional
        (lam0, act0, side0) warm start. The tier keeps theta in float64
        (only its bulk phase rounds it to float32)."""
        in_dtype = torch.float64 if self.tier else self.dtype
        thetas = torch.as_tensor(thetas, device=self.device).to(in_dtype)
        if self.tier:
            return self._tier_batch(thetas, warm)
        w = (None,) * 3 if warm is None else tuple(warm)
        return solve_batch(self.arrays, thetas, *w, max_iter=self.iter_limit,
                           primal_tol=self.primal_tol, sign_tol=self.sign_tol,
                           use_cholesky=self.symmetric)

    def solve(self, theta) -> tuple[np.ndarray, float, int, dict]:
        """Single solve (reference solve(), src/utils.jl:268-283): a batch
        of one through the same path. Returns (U, fval, status, info)."""
        theta = np.asarray(theta, dtype=np.float64).reshape(1, -1)
        sol = self.solve_batch(theta)
        info = {
            "iterations": int(sol.iters[0]),
            "lam": sol.lam[0].cpu().numpy(),
            "active": sol.active[0].cpu().numpy(),
            "side": sol.side[0].cpu().numpy(),
        }
        return (sol.U[0].cpu().numpy().astype(np.float64), float(sol.fval[0]),
                int(sol.status[0]), info)
