"""Sequential lexicographic hierarchy for prioritized soft constraints.

Port of ``linearmpc_tpu/ops/hierarchy.py`` (``LexSolver``, ``:39-141``),
the exact semantics of DAQP's break_points hierarchy
(``settings.hierarchy = "lexicographic"``). For each priority level,
highest first:

* soft rows of this level carry the soft weight (proximal rho);
* soft rows of higher levels are held hard at their bounds relaxed by
  exactly the violation recorded when their level was solved;
* soft rows of lower levels are ignored (immutable);
* hard rows are always enforced.

The last level's solution is returned. Each level is one batched dual
active-set solve in float64 with the level's own working-set system (its
soft diagonal, its immutable rows and, for m <= 12, its subset table),
warm-started from the previous level. On CUDA, at m <= 10, a level runs
K1's float64 instantiation (``bulk.phase1``, the same iteration as the
plain loop bit for bit) with the level's table and host masks; above that
the plain float64 loop runs on the card. The hierarchy is float64 whatever
the engine's dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bulk
from .dual_active_set import LDPArrays, Solution, _active_set_loop, to_device_arrays
from .ldp import SUBSET_CACHE_MAX_M, LDPData, precompute_subset_inverses


class LexSolver:
    """The per-level float64 solver arrays of an LDP and its batched
    sequential solve. Requires >= 2 priority levels among the soft rows."""

    def __init__(self, ldp: LDPData, *, device, soft_weight: float = 1e6,
                 iter_limit: int = 1000, primal_tol: float = 1e-6, sign_tol: float = 1e-11,
                 margin: float = 1e-9):
        if ldp.prio is None:
            raise ValueError("LDPData carries no priorities")
        soft = np.asarray(ldp.is_soft)
        prio = np.asarray(ldp.prio)
        self.levels = [int(p) for p in np.unique(prio[soft])]
        if len(self.levels) < 2:
            raise ValueError("lexicographic mode needs >= 2 priority levels")
        self.ldp = ldp
        self.device = torch.device(device)
        self.iter_limit = int(iter_limit)
        self.primal_tol = float(primal_tol)
        self.sign_tol = float(sign_tol)
        self.margin = float(margin)
        m = ldp.m
        self.base = base = to_device_arrays(ldp, torch.float64, self.device)
        rho_val = 1.0 / float(soft_weight)
        G = np.asarray(ldp.G, np.float64)
        self.level_arrays: list[tuple[LDPArrays, torch.Tensor]] = []
        for lvl in self.levels:
            mask = soft & (prio == lvl)
            later = soft & (prio > lvl)
            rho = np.where(mask, rho_val, 0.0)
            immut = np.asarray(ldp.is_immutable, bool) | later
            # each level has its own soft diagonal, so its own working-set
            # inverse cache (a gather + matvec per iteration for small m)
            subset = None
            if 0 < m <= SUBSET_CACHE_MAX_M:
                subset = torch.as_tensor(precompute_subset_inverses(
                    dataclasses.replace(ldp, rho_soft=rho)), device=self.device)
            immut_host = torch.as_tensor(immut)
            arrays = base._replace(
                G_solve=torch.as_tensor(G + np.diag(rho), device=self.device),
                is_immutable=immut_host.to(self.device), is_immutable_host=immut_host,
                subset_inv=subset)
            self.level_arrays.append((arrays, torch.as_tensor(mask, device=self.device)))

    def _level_solve(self, arrays: LDPArrays, du_t, dl_t, lam, act, side):
        """One level's batched solve: K1's float64 instantiation on CUDA
        where its subset table fits the kernel (m <= 10), else the plain
        float64 loop on the arrays' device."""
        kw = dict(max_iter=self.iter_limit, primal_tol=self.primal_tol,
                  sign_tol=self.sign_tol)
        m = du_t.shape[1]
        if arrays.subset_inv is not None and m <= bulk.MAX_M and du_t.is_cuda:
            lam, act, side, iters, done = bulk.phase1(
                arrays.subset_inv, arrays.G, du_t.contiguous(), dl_t.contiguous(),
                arrays.is_eq_host, arrays.is_immutable_host, lam.contiguous(),
                act.contiguous(), side.contiguous(), **kw)
            return lam, act, side, iters, done
        return _active_set_loop(arrays, du_t, dl_t, lam, act, side, use_cholesky=True, **kw)

    def solve_batch(self, thetas) -> Solution:
        base = self.base
        th = torch.as_tensor(thetas, device=self.device).to(torch.float64)
        B, m = th.shape[0], base.G.shape[0]
        dt = th @ base.Dth.T
        du_t, dl_t = base.du + dt, base.dl + dt
        off_u = torch.zeros((B, m), dtype=torch.float64, device=self.device)
        off_l = torch.zeros_like(off_u)
        all_done = torch.ones(B, dtype=torch.bool, device=self.device)
        iters = torch.zeros(B, dtype=torch.int32, device=self.device)
        lam = torch.zeros_like(off_u)
        # per-level warm starts: the previous level differs only in the soft
        # diagonal, the frozen rows and the offsets, so its working set is a
        # few changes away (DAQP reuses its workspace across levels too)
        act = base.is_eq.expand(B, m)
        side = torch.ones((B, m), dtype=torch.bool, device=self.device)
        for arrays, mask in self.level_arrays:
            lam, act, side, it, done = self._level_solve(
                arrays, du_t + off_u, dl_t - off_l, lam, act | base.is_eq, side)
            all_done = all_done & done
            iters = iters + it
            c = lam @ base.G.T
            viol_u = (-(du_t + off_u + c)).clamp_min(0.0)
            viol_l = (dl_t - off_l + c).clamp_min(0.0)
            # freeze this level's achieved violations: relax its rows' bounds
            # by exactly the violation (plus a round-off margin) so later
            # levels hold them hard without infeasibility
            off_u = off_u + torch.where(mask, viol_u + self.margin, 0.0)
            off_l = off_l + torch.where(mask, viol_l + self.margin, 0.0)
        U = base.u_off + th @ base.Uth_off.T - lam @ base.HinvET.T
        f_t = base.f + th @ base.f_theta.T
        fval = 0.5 * ((U @ base.H.T) * U).sum(1) + (f_t * U).sum(1)
        one = torch.ones(B, dtype=torch.int32, device=self.device)
        # the last level's working set and sides are reported
        return Solution(U, lam, lam != 0.0, lam > 0.0, fval, iters,
                        torch.where(all_done, one, -one))
