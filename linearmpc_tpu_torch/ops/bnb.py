"""Branch-and-bound over dual active-set relaxations for hybrid MPC: the
per-lane depth-first search.

Port of ``linearmpc_tpu/ops/bnb.py`` (``solve_bnb_single``, ``:52-188``),
the analog of DAQP's MIQP branch-and-bound. A binary constraint must hold
with equality at its upper or lower bound; each node fixes a subset of
binary rows to one bound and solves the relaxation with those rows forced
(``dual_active_set.solve_single`` with ``forced_mask``/``forced_side``).

The JAX package ``vmap``s one lane's ``while_loop``; here the batch is
written out: every lane keeps its own node stack and top, and each pass
pops one node from every lane that still has one (and is under the node
limit) and solves those relaxations together. Lanes are independent, so
each follows exactly the search of its own loop. Branching picks the most
fractional unfixed binary row; the far child is pushed first and the near
one last (explored next). Children are warm-started from the parent
relaxation's multipliers and working set, which changes iteration counts,
never solutions.

The engine runs this search for single solves outside the float32
incremental frontier and for a non-symmetric H (``engine.py:1257-1279``,
``:1441-1442``, ``:1475``).
"""

from __future__ import annotations

import torch

from .dual_active_set import LDPArrays, Solution, solve_single


# the finite "infinite" sentinel of the B&B paths in both dtypes: it
# dominates every reachable objective and bound and stays finite
BIG = 1e30
# a binary row within this of a bound is on it (not fractional)
BIN_TOL = 1e-6


def solve_bnb_dfs(arr: LDPArrays, thetas, *, stack_cap: int = 64, node_limit: int = 1024,
                  max_iter: int = 500, primal_tol: float = 1e-6, sign_tol: float = 1e-12,
                  use_cholesky: bool = True,
                  warm_nodes: bool = True) -> Solution:
    """Solve a (B, n_theta) batch of hybrid LDP instances, each by its own
    depth-first search, in the dtype of ``arr``. Status 1 = proven optimal,
    2 = exact incumbent but the node limit stopped the search, -2 = no
    integer-feasible point found."""
    dtype, dev = arr.G.dtype, arr.G.device
    th = torch.as_tensor(thetas, device=dev).to(dtype)
    B, m, n = th.shape[0], arr.G.shape[0], arr.u_off.shape[0]
    big = BIG
    idx = torch.arange(m, device=dev)
    dt = th @ arr.Dth.T
    du_t, dl_t = arr.du + dt, arr.dl + dt
    branchable_rows = (arr.is_binary & ~arr.is_immutable & (arr.up_finite | arr.lo_finite))

    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    s_fixed, s_side = zb(B, stack_cap, m), zb(B, stack_cap, m)
    s_lam = torch.zeros((B, stack_cap, m), dtype=dtype, device=dev)
    s_act, s_ws = zb(B, stack_cap, m), torch.ones((B, stack_cap, m), dtype=torch.bool,
                                                  device=dev)
    top = torch.ones(B, dtype=torch.int64, device=dev)  # root: nothing fixed, cold
    inc_fval = torch.full((B,), big, dtype=dtype, device=dev)
    inc_U = torch.zeros((B, n), dtype=dtype, device=dev)
    inc_lam = torch.zeros((B, m), dtype=dtype, device=dev)
    inc_act, inc_side, inc_found = zb(B, m), zb(B, m), zb(B)
    nodes = torch.zeros(B, dtype=torch.int32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)

    while True:
        run = torch.nonzero((top > 0) & (nodes < node_limit)).squeeze(1)
        if run.numel() == 0:
            break
        t = top[run] - 1  # pop the top node
        fixed, fside = s_fixed[run, t], s_side[run, t]
        warm = ((s_lam[run, t], s_act[run, t], s_ws[run, t]) if warm_nodes
                else (None, None, None))
        sol = solve_single(arr, th[run], *warm, max_iter=max_iter, primal_tol=primal_tol,
                          sign_tol=sign_tol, use_cholesky=use_cholesky,
                          forced_mask=fixed, forced_side=fside)
        feasible = sol.status > 0
        found, fbest = inc_found[run], inc_fval[run]
        pruned = ~feasible | (found & (sol.fval >= fbest))

        # fractionality of unfixed binary rows: distance to the nearer viable
        # (finite) bound -- never branch onto an infinite bound
        c = sol.lam @ arr.G.T
        slack_up = torch.where(arr.up_finite, du_t[run] + c, big)
        slack_lo = torch.where(arr.lo_finite, -dl_t[run] - c, big)
        frac = torch.where(branchable_rows & ~fixed, torch.minimum(slack_up, slack_lo), -big)
        jb = frac.argmax(1)
        integral = frac.gather(1, jb[:, None])[:, 0] <= BIN_TOL

        better = feasible & integral & ~pruned & (sol.fval < fbest)
        bt = better[:, None]
        inc_fval[run] = torch.where(better, sol.fval, fbest)
        inc_U[run] = torch.where(bt, sol.U, inc_U[run])
        inc_lam[run] = torch.where(bt, sol.lam, inc_lam[run])
        inc_act[run] = torch.where(bt, sol.active, inc_act[run])
        inc_side[run] = torch.where(bt, sol.side, inc_side[run])
        inc_found[run] = found | better

        # branch on jb: push the far bound first, the near one last (popped next)
        branch = ~pruned & ~integral
        onehot = idx == jb[:, None]
        child_fixed = fixed | onehot
        near_up = (slack_up.gather(1, jb[:, None]) <= slack_lo.gather(1, jb[:, None]))
        far_viable = torch.where(near_up[:, 0], arr.lo_finite[jb], arr.up_finite[jb])

        def push(t, side_of_node, side_of_ws, do):
            do = do & (t < stack_cap)
            ix = t.clamp(max=stack_cap - 1)
            d = do[:, None]
            r = run
            s_fixed[r, ix] = torch.where(d, child_fixed, s_fixed[r, ix])
            s_side[r, ix] = torch.where(d, side_of_node, s_side[r, ix])
            s_lam[r, ix] = torch.where(d, sol.lam, s_lam[r, ix])
            s_act[r, ix] = torch.where(d, sol.active, s_act[r, ix])
            s_ws[r, ix] = torch.where(d, side_of_ws, s_ws[r, ix])
            return t + do.to(t.dtype)

        # children inherit the parent's dual state; the branched row's
        # working-set side follows the bound it is forced to
        t = push(t, torch.where(onehot, ~near_up, fside),
                 torch.where(onehot, ~near_up, sol.side), branch & far_viable)
        t = push(t, torch.where(onehot, near_up, fside),
                 torch.where(onehot, near_up, sol.side), branch)
        top[run] = t
        nodes[run] += 1
        iters[run] += sol.iters

    budgeted = (top > 0) & (nodes >= node_limit)
    one = torch.ones(B, dtype=torch.int32, device=dev)
    status = torch.where(inc_found, torch.where(budgeted, 2 * one, one), -2 * one)
    return Solution(inc_U, inc_lam, inc_act, inc_side, inc_fval, iters, status)
