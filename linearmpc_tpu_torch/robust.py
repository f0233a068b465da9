"""Robust constraint tightening for additive box noise and x0 uncertainty.

A-priori tightening of stage constraints under w in [wmin, wmax] and an
initial-state uncertainty box |dx0|: worst-case accumulation of |A F^k| terms
along the horizon (reference src/robust.jl:1-29).
"""

from __future__ import annotations

import numpy as np


def constraint_tightening(Ax, F, ks, wmin, wmax, x0_uncertainty):
    """Return (tight_upper, tight_lower), each of length m*len(ks), the amount
    by which upper bounds must shrink / lower bounds grow so the nominal
    prediction satisfies the constraint for every admissible disturbance
    realization. Time steps ``ks`` are 1-based (k=1 is the initial state);
    steps before k=2 receive no tightening, matching the reference."""
    Ax = np.atleast_2d(np.asarray(Ax, dtype=np.float64))
    m, nx = Ax.shape
    ks = list(ks)
    nk = len(ks)
    tight_upper = np.zeros(m * nk)
    tight_lower = np.zeros(m * nk)
    wmin = np.asarray(wmin, dtype=np.float64).ravel()
    wmax = np.asarray(wmax, dtype=np.float64).ravel()
    dx0 = np.abs(np.asarray(x0_uncertainty, dtype=np.float64).ravel())

    # Initial-state uncertainty enters symmetrically at every step.
    accum_upper = np.abs(Ax) @ dx0
    accum_lower = accum_upper.copy()

    ki = sum(1 for k in ks if k < 2)  # skip steps before k=2
    if ki >= nk:
        return tight_upper, tight_lower
    Ck = Ax
    for k in range(2, max(ks) + 1):
        Ck = Ck @ F
        accum_upper = accum_upper + np.where(Ck > 0, Ck * wmax, Ck * wmin).sum(axis=1)
        accum_lower = accum_lower - np.where(Ck < 0, Ck * wmax, Ck * wmin).sum(axis=1)
        if k == ks[ki]:
            tight_upper[m * ki : m * (ki + 1)] = accum_upper
            tight_lower[m * ki : m * (ki + 1)] = accum_lower
            ki += 1
            if ki >= nk:
                break
    return tight_upper, tight_lower
