"""Iteration-complexity certification for the dual active-set solver.

Port of ``linearmpc_tpu/certify.py``: host NumPy, with each wave's
emptiness checks one batched interior-point LP call on the device
(``ops/lp_ipm.chebyshev_batch``), borderline lanes confirmed by HiGHS.

The reference delegates to the external ASCertain package
(src/certify.jl:18-29): a parametric-programming analysis that bounds the
worst-case number of working-set changes DAQP needs over a parameter box.

Here the certification explores the solver's reachable state graph
symbolically over the (single-sided) LDP. A state is (working set AS,
iteration count); over a polyhedral parameter region the candidate
multiplier lambda*(theta) and the constraint slacks are affine, so the
branch taken is decided by sign conditions that split the region:

  * no multiplier sign-violation and no primal violation -> terminate;
  * primal violation -> the solver adds the *most* violated row j; the
    argmax over affine violations splits the region into disjoint cells
    (v_j >= v_k for all k), one child per winning j -> (AS + {j}, k+1);
  * multiplier sign-violation -> the blocking index is selected by a
    min-ratio test that is not affine in theta, so removals branch
    conservatively over every sign-violating i -> (AS - {i}, k+1).

Addition branches follow the solver's deterministic rule exactly; removal
branches over-approximate the reachable executions, so the resulting bound
is a sound (possibly conservative) upper bound on the solver's iteration
count over the box.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .condense import mpc2mpqp
from .explicit import _chebyshev_radius, make_singlesided, offline_device
from .ops.lp_ipm import chebyshev_batch
from .types import ACTIVE, IMMUTABLE


@dataclass
class CertRegion:
    Ath: np.ndarray
    bth: np.ndarray
    active_set: tuple
    iterations: int
    center: np.ndarray


@dataclass
class CertificationResult:
    mpc: object
    max_iterations: int
    partition: list
    exhausted: bool  # True if exploration hit the iteration cap (no certificate)
    # IPM chunks and lanes, HiGHS confirmations
    stats: dict | None = None


def certify(mpc, *, prange=None, AS0=(), iter_limit: int = 60,
            max_regions: int = 100000, region_tol: float = 1e-7,
            single_soft: bool = True, device=None) -> CertificationResult:
    """Worst-case iteration certification over ``prange``
    (reference src/certify.jl:18-29). The LP oracle runs on ``device``
    (``explicit.offline_device``: the caller's, else the device of
    ``mpc.engine``, else the card)."""
    import warnings

    dev = offline_device(mpc, device)
    stats = dict(ipm_chunks=0, ipm_lanes=0, highs=0)
    qp = make_singlesided(mpc2mpqp(mpc), single_soft=single_soft,
                          soft_weight=mpc.settings.soft_weight)
    if prange is None:
        warnings.warn("No parameter range defined. Using default limits [-100, 100].")
        prange = mpc.parameter_range()
    lb, ub = prange.lower(), prange.upper()
    nth = qp.W.shape[1]
    m, n = qp.A.shape

    Hinv = np.linalg.inv((qp.H + qp.H.T) / 2)
    AHinv = qp.A @ Hinv
    G = AHinv @ qp.A.T
    U0F = -Hinv @ qp.f_theta
    U0g = -Hinv @ qp.f
    # slack_j(theta) = b_j + W_j theta - A_j U(theta); U depends on AS
    ignore = (qp.senses & IMMUTABLE) != 0
    always = (qp.senses & ACTIVE) != 0

    partition: list[CertRegion] = []
    max_iter_seen = 0
    exhausted = False

    # work item: (AS tuple, iteration count, region rows, interior hint)
    stack = [(tuple(sorted(set(AS0) | set(np.where(always)[0]))), 0,
              np.zeros((0, nth)), np.zeros(0), None)]

    def lam_affine(AS):
        AS = np.asarray(AS, dtype=int)
        if len(AS) == 0:
            return np.zeros((0, nth)), np.zeros(0), True
        M = G[np.ix_(AS, AS)]
        if np.linalg.cond(M) > 1e11:
            return None, None, False
        Minv = np.linalg.inv(M)
        Flam = Minv @ (qp.A[AS] @ U0F - qp.W[AS])
        glam = Minv @ (qp.A[AS] @ U0g - qp.b[AS])
        return Flam, glam, True

    rng_samples = np.random.default_rng(0)
    probe = lb + (ub - lb) * rng_samples.random((64, nth))

    def _prescreen(Ath, bth, hint):
        """Sampling fast path: a strictly interior point certifies
        nonemptiness without an LP; zero rows with negative rhs certify
        emptiness. Returns (verdict-or-None, point, filtered rows)."""
        if len(bth) == 0:
            return True, (lb + ub) / 2, (Ath, bth)
        nrm = np.linalg.norm(Ath, axis=1)
        zero = nrm <= 1e-12
        if np.any(bth[zero] < -1e-9):
            return False, None, (Ath, bth)
        if np.any(zero):
            Ath, bth = Ath[~zero], bth[~zero]
            if len(bth) == 0:
                return True, (lb + ub) / 2, (Ath, bth)
        if hint is not None:
            if float(np.max(Ath @ hint - bth)) < -1e-9:
                return True, hint, (Ath, bth)
        viol = Ath @ probe.T - bth[:, None]
        good = np.where(np.max(viol, axis=0) < -1e-9)[0]
        if len(good):
            return True, probe[good[0]], (Ath, bth)
        return None, None, (Ath, bth)

    def nonempty_batch(cands):
        """Batched emptiness check of [(rows, rhs, hint), ...]: probe fast
        path per candidate, then ONE batched interior-point LP call
        (ops/lp_ipm.py) for the rest; borderline lanes confirmed on host."""
        results = [None] * len(cands)
        lp_items = []
        for i, (Ath, bth, hint) in enumerate(cands):
            verdict, pt, (Af, bf) = _prescreen(Ath, bth, hint)
            if verdict is not None:
                results[i] = (verdict, pt)
            else:
                lp_items.append((i, Af, bf))
        if lp_items:
            m_pad = ((max(len(bf) for _i, _A, bf in lp_items) + 31) // 32) * 32
            As = np.zeros((len(lp_items), m_pad, nth))
            bs = np.ones((len(lp_items), m_pad))
            for k, (_i, Af, bf) in enumerate(lp_items):
                As[k, : len(bf)] = Af
                bs[k, : len(bf)] = bf
            rs, centers, gaps = chebyshev_batch(As, bs, lb, ub, device=dev, stats=stats)
            for k, (i, Af, bf) in enumerate(lp_items):
                r, c = rs[k], centers[k]
                # borderline, stalled (large gap), or non-finite lanes go
                # to the exact host LP -- an off-by-more-than-tol radius
                # here would prune certification branches unsoundly
                # 1e-4 window: on near-parallel-row geometries the IPM radius
                # can be off by a few 1e-6 at tiny duality gap (QR-IPM note
                # in ops/lp_ipm.py); only the host LP certifies the sign there
                if (not np.isfinite(r) or abs(r - region_tol) < 1e-4
                        or gaps[k] > 1e-9):
                    stats["highs"] += 1
                    r, c = _chebyshev_radius(Af, bf, lb, ub)
                    r = -np.inf if c is None else r
                results[i] = (r > region_tol, c)
        return results

    # WAVE-BATCHED exploration: states are expanded in
    # waves of up to ``wave_size``; each wave makes TWO batched oracle
    # calls (phase A: every state's removal cells + its dual-feasible
    # subregion; phase B: every surviving state's addition cells +
    # termination cell) instead of two calls PER STATE. Exploration
    # content is identical to the per-state loop -- only the order
    # of expansion differs, which the reachable-set semantics do not
    # depend on.
    wave_size = 256
    while stack:
        if len(partition) >= max_regions:
            exhausted = True
            break
        wave = []
        while stack and len(wave) < wave_size:
            AS, k, Ath, bth, hint = stack.pop()
            if k >= iter_limit:
                exhausted = True
                max_iter_seen = max(max_iter_seen, k)
                continue
            Flam, glam, ok = lam_affine(AS)
            if not ok:
                continue  # degenerate working set: unreachable exactly
            wave.append([AS, k, Ath, bth, hint, Flam, glam])
        if not wave:
            continue

        # ---- phase A: removal cells + dual-feasible subregion per state
        cands_a, meta_a = [], []
        df_rows = [None] * len(wave)
        for si, (AS, k, Ath, bth, hint, Flam, glam) in enumerate(wave):
            ASl = list(AS)
            for pos, i in enumerate(ASl):
                if always[i]:
                    continue
                rows = np.vstack([Ath, Flam[pos][None, :]])
                rhs = np.concatenate([bth, [-glam[pos]]])  # Flam th + glam < 0
                cands_a.append((rows, rhs, hint))
                meta_a.append((si, i, rows, rhs))
            rows_df = [Ath]
            rhs_df = [bth]
            for pos, i in enumerate(ASl):
                if always[i]:
                    continue
                rows_df.append(-Flam[pos][None, :])
                rhs_df.append([glam[pos]])
            Ath_df = np.vstack(rows_df)
            bth_df = np.concatenate([np.atleast_1d(r) for r in rhs_df])
            df_rows[si] = (Ath_df, bth_df)
            cands_a.append((Ath_df, bth_df, hint))
            meta_a.append((si, None, None, None))

        verdicts_a = nonempty_batch(cands_a)
        df_center = [None] * len(wave)
        for (ne, pt), (si, i, rows, rhs) in zip(verdicts_a, meta_a):
            AS, k = wave[si][0], wave[si][1]
            if i is not None:
                if ne:
                    stack.append((tuple(sorted(set(AS) - {i})), k + 1,
                                  rows, rhs, pt))
            elif ne:
                df_center[si] = pt

        # ---- phase B: addition cells + termination cell for states whose
        # dual-feasible subregion is nonempty
        cands_b, meta_b = [], []
        for si, (AS, k, _Ath, _bth, _hint, Flam, glam) in enumerate(wave):
            center = df_center[si]
            if center is None:
                continue
            ASl = list(AS)
            if len(ASl):
                F = U0F - Hinv @ qp.A[ASl].T @ Flam
                g = U0g - Hinv @ qp.A[ASl].T @ glam
            else:
                F, g = U0F, U0g
            Ath_df, bth_df = df_rows[si]
            # slacks of inactive rows: s_j(theta) = Sf_j th + sg_j
            inact = [j for j in range(m) if j not in AS and not ignore[j]]
            Sf = qp.W[inact] - qp.A[inact] @ F
            sg = qp.b[inact] - qp.A[inact] @ g
            if len(AS) < n:
                for jj, j in enumerate(inact):
                    rows = [Ath_df, Sf[jj][None, :]]     # slack_j < 0
                    rhs = [bth_df, [-sg[jj]]]
                    for kk in range(len(inact)):         # v_j >= v_k
                        if kk == jj:
                            continue
                        rows.append((Sf[jj] - Sf[kk])[None, :])
                        rhs.append([sg[kk] - sg[jj]])
                    rows = np.vstack(rows)
                    rhs = np.concatenate([np.atleast_1d(r) for r in rhs])
                    cands_b.append((rows, rhs, center))
                    meta_b.append((si, j, rows, rhs))
            rows_t = np.vstack([Ath_df, -Sf]) if len(inact) else Ath_df
            rhs_t = np.concatenate([bth_df, sg]) if len(inact) else bth_df
            cands_b.append((rows_t, rhs_t, center))
            meta_b.append((si, None, rows_t, rhs_t))

        for (ne, pt), (si, j, rows, rhs) in zip(nonempty_batch(cands_b),
                                                meta_b):
            if not ne:
                continue
            AS, k = wave[si][0], wave[si][1]
            if j is not None:
                stack.append((tuple(sorted(set(AS) | {j})), k + 1,
                              rows, rhs, pt))
            elif len(partition) < max_regions:
                partition.append(CertRegion(rows, rhs, tuple(AS), k + 1, pt))
                max_iter_seen = max(max_iter_seen, k + 1)

    return CertificationResult(mpc, max_iter_seen, partition, exhausted, stats)
