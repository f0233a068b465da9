"""(Robust control) invariant set computation.

Port of ``linearmpc_tpu/invariant.py``, carried over unchanged: host
NumPy with SciPy's HiGHS as the LP oracle.

Iterative pre-set intersection until convergence, with worst-case box-noise
support shrinkage, control-input elimination by polytope projection, and
minimal-representation pruning (reference src/invariant.jl:1-61, which
delegates projection/minrep to the external PolyDAQP package; here
Fourier-Motzkin elimination + LP redundancy removal are implemented
directly, with scipy's HiGHS as the LP oracle).

Polytopes use the row convention {x : A x <= b}. The reference stores
normals column-wise; the math is identical transposed.
"""

from __future__ import annotations

import numpy as np


def _lp_max(c, A, b):
    """max c'x s.t. Ax <= b. Returns (value, success)."""
    from scipy.optimize import linprog

    res = linprog(-np.asarray(c, dtype=np.float64), A_ub=A, b_ub=b,
                  bounds=[(None, None)] * A.shape[1], method="highs")
    if res.status == 3:  # unbounded
        return np.inf, True
    if not res.success:
        return -np.inf, False
    return -res.fun, True


def normalize_rows(A, b, tol=1e-12):
    nrm = np.linalg.norm(A, axis=1)
    ok = nrm > tol
    A = A[ok] / nrm[ok, None]
    b = b[ok] / nrm[ok]
    return A, b


def minrep(A, b, *, keep=None, tol_weak: float = 1e-8):
    """Minimal representation of {x: Ax <= b}: drop every row that the other
    rows imply (max A_i x over the rest <= b_i + tol). Rows in ``keep``
    (indices) are never dropped."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).ravel()
    m = len(b)
    keep = set() if keep is None else set(int(i) for i in keep)
    alive = np.ones(m, dtype=bool)
    for i in range(m):
        if i in keep:
            continue
        mask = alive.copy()
        mask[i] = False
        if not mask.any():
            continue
        val, ok = _lp_max(A[i], A[mask], b[mask])
        if ok and val <= b[i] + tol_weak:
            alive[i] = False
    return A[alive], b[alive], np.where(alive)[0]


def eliminate(A, b, elim: list[int], *, prune_every: bool = True, tol: float = 1e-9):
    """Fourier-Motzkin elimination of the coordinates in ``elim`` from
    {z: Az <= b}; returns the projection onto the remaining coordinates."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).ravel()
    for e in sorted(elim, reverse=True):
        c = A[:, e]
        pos = np.where(c > tol)[0]
        neg = np.where(c < -tol)[0]
        zer = np.where(np.abs(c) <= tol)[0]
        rows = [np.delete(A[zer], e, axis=1)]
        rhs = [b[zer]]
        for i in pos:
            for j in neg:
                # c_i > 0, c_j < 0: combine to cancel coordinate e
                w_i, w_j = -c[j], c[i]
                rows.append(np.delete(w_i * A[i] + w_j * A[j], e)[None, :])
                rhs.append(np.asarray([w_i * b[i] + w_j * b[j]]))
        A = np.vstack(rows) if rows else np.zeros((0, A.shape[1] - 1))
        b = np.concatenate(rhs) if rhs else np.zeros(0)
        A, b = normalize_rows(A, b)
        if prune_every and len(b) > 2 * A.shape[1] + 8:
            A, b, _ = minrep(A, b)
    return A, b


def invariant_set(
    F,
    xmin=None,
    xmax=None,
    *,
    wmin=None,
    wmax=None,
    G=None,
    umin=None,
    umax=None,
    Ax=None,
    bx=None,
    Agu=None,
    Agx=None,
    bg=None,
    max_iter: int = 500,
    eps_shrink: float = 1e-3,
):
    """Compute an invariant polytope {x : A x <= b} for x+ = F x (+ G u),
    with state box/polytope constraints, input box/polytope constraints,
    and additive box disturbance w in [wmin, wmax]
    (reference src/invariant.jl:1-61; same keyword semantics, but the
    polytope rows are returned row-wise: (A, b) with A x <= b).
    """
    F = np.atleast_2d(np.asarray(F, dtype=np.float64))
    nx = F.shape[0]
    G = None if G is None or np.size(G) == 0 else np.atleast_2d(np.asarray(G, dtype=np.float64))
    nu = 0 if G is None else G.shape[1]

    # state set
    if xmax is not None and np.size(xmax):
        A = np.vstack([np.eye(nx), -np.eye(nx)])
        b = np.concatenate([np.asarray(xmax, dtype=np.float64).ravel(),
                            -np.asarray(xmin, dtype=np.float64).ravel()])
    else:
        A = np.zeros((0, nx))
        b = np.zeros(0)
    if Ax is not None and np.size(Ax):
        A = np.vstack([A, np.atleast_2d(Ax)])
        b = np.concatenate([b, np.asarray(bx, dtype=np.float64).ravel()])

    # input set (rows over (x, u))
    Agx_rows = np.zeros((0, nx))
    Agu_rows = np.zeros((0, nu))
    bg_rows = np.zeros(0)
    if nu and umax is not None and np.size(umax):
        Agu_rows = np.vstack([np.eye(nu), -np.eye(nu)])
        Agx_rows = np.zeros((2 * nu, nx))
        bg_rows = np.concatenate([np.asarray(umax, dtype=np.float64).ravel(),
                                  -np.asarray(umin, dtype=np.float64).ravel()])
    if Agu is not None and np.size(Agu):
        Agu_rows = np.vstack([Agu_rows, np.atleast_2d(Agu)])
        Agx_rows = np.vstack([
            Agx_rows,
            np.atleast_2d(Agx) if Agx is not None and np.size(Agx) else np.zeros((np.atleast_2d(Agu).shape[0], nx)),
        ])
        bg_rows = np.concatenate([bg_rows, np.asarray(bg, dtype=np.float64).ravel()])

    wmin = None if wmin is None or np.size(wmin) == 0 else np.asarray(wmin, dtype=np.float64).ravel()
    wmax = None if wmax is None or np.size(wmax) == 0 else np.asarray(wmax, dtype=np.float64).ravel()

    for _ in range(max_iter):
        badd = b.copy()
        if wmax is not None:
            # shrink by the support function of the noise box
            badd = badd - np.where(A > 0, A * wmax, A * wmin).sum(axis=1)

        if nu and len(bg_rows):
            # project out u from {(x,u): A(Fx+Gu) <= badd, Agx x + Agu u <= bg}
            Az = np.vstack([
                np.hstack([A @ F, A @ G]),
                np.hstack([Agx_rows, Agu_rows]),
            ])
            bz = np.concatenate([badd, bg_rows])
            Aadd, badd = eliminate(Az, bz, list(range(nx, nx + nu)))
        else:
            Aadd = A @ F
            Aadd, badd = normalize_rows(Aadd, badd)

        nold = len(b)
        A2, b2, kept = minrep(np.vstack([A, Aadd]), np.concatenate([b, badd]),
                              keep=range(nold), tol_weak=1e-6 + 1e-5)
        if len(b2) == nold:
            A, b = A2, b2
            break
        new_ids = np.where(kept >= nold)[0]
        b2[new_ids] -= eps_shrink
        A, b, _ = minrep(A2, b2, keep=new_ids)
    return A, b
