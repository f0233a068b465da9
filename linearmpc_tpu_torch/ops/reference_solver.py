"""Plain NumPy float64 dual active-set reference solver.

An independent, sequential host implementation of the same LDP dual
active-set method as ops/dual_active_set.py, used for differential testing
of the batched device kernel and for accuracy accounting in benchmarks
(playing the role DAQP plays for the reference's golden tests,
test/runtests.jl:62-66). Written index-based (grow/shrink working set)
rather than mask-based, so the two implementations share no code paths.
"""

from __future__ import annotations

import numpy as np

from .ldp import LDPData


def solve_ldp_numpy(
    ldp: LDPData,
    theta: np.ndarray,
    *,
    max_iter: int = 1000,
    primal_tol: float = 1e-6,
    sign_tol: float = 1e-12,
):
    """Returns (U, lam, active_set(list), n_iter, status)."""
    theta = np.asarray(theta, dtype=np.float64).ravel()
    m = ldp.m
    du = ldp.du + ldp.Dth @ theta
    dl = ldp.dl + ldp.Dth @ theta
    G = ldp.G + np.diag(np.asarray(ldp.rho_soft, dtype=np.float64))

    work: list[int] = list(np.where(ldp.is_eq)[0])
    sides: dict[int, bool] = {i: True for i in work}
    lam = np.zeros(m)
    status = -1
    it = 0
    while it < max_iter:
        it += 1
        W = np.asarray(work, dtype=int)
        if len(W):
            d_W = np.where([sides[i] for i in W], du[W], dl[W])
            GWW = G[np.ix_(W, W)]
            try:
                lam_W = np.linalg.solve(GWW, -d_W)
            except np.linalg.LinAlgError:
                # degenerate working set: minimum-norm iterate, like the
                # batched kernel's pinv subset entries
                lam_W = np.linalg.lstsq(GWW, -d_W, rcond=None)[0]
        else:
            lam_W = np.zeros(0)

        removable = [
            k for k, i in enumerate(work)
            if not ldp.is_eq[i]
            and ((sides[i] and lam_W[k] < -sign_tol) or (not sides[i] and lam_W[k] > sign_tol))
        ]
        if removable:
            # partial step to the first blocking multiplier; drop it
            alphas = []
            for k in removable:
                i = work[k]
                denom = lam[i] - lam_W[k]
                alphas.append((lam[i] / denom if abs(denom) > 1e-300 else 0.0, k))
            alpha, kb = min(alphas)
            alpha = min(max(alpha, 0.0), 1.0)
            for k, i in enumerate(work):
                lam[i] = lam[i] + alpha * (lam_W[k] - lam[i])
            ib = work[kb]
            lam[ib] = 0.0
            del sides[ib]
            work.pop(kb)
            continue

        lam[:] = 0.0
        lam[W] = lam_W
        c = ldp.G @ lam
        slack_up = du + c
        slack_lo = -dl - c
        best, best_i, best_up = -np.inf, -1, True
        for i in range(m):
            if i in sides or ldp.is_immutable[i]:
                continue
            if -slack_up[i] > best:
                best, best_i, best_up = -slack_up[i], i, True
            if -slack_lo[i] > best:
                best, best_i, best_up = -slack_lo[i], i, False
        if best <= primal_tol:
            # optimality also requires the working-set system to be solved
            # exactly: on a degenerate (singular) set the lstsq fallback
            # leaves a residual, i.e. the ACTIVE rows are violated even
            # though every inactive row passes. Report no certificate
            # rather than an infeasible "optimum".
            if len(W):
                res = np.max(np.abs(np.where(
                    [sides[i] for i in W], du[W], dl[W]) + c[W]))
            else:
                res = 0.0
            status = 1 if res <= primal_tol else -1
            break
        work.append(best_i)
        sides[best_i] = best_up

    U = ldp.u_off + ldp.Uth_off @ theta - ldp.HinvET @ lam
    return U, lam, work, it, status
