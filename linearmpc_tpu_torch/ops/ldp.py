"""Lowering of a dense mpQP to batched LDP (least-distance) solver arrays.

The reference solves the condensed QP with DAQP, whose C core first maps the
QP to a least-distance problem via a Cholesky factor of H (reference
src/codegen.jl:239-280 ``qp2ldp`` and the external libdaqp). Here the same
transform is precomputed once on the host, in a form chosen for lockstep
batched iteration (carried over from ``linearmpc_tpu/ops/ldp.py``, plus
``ldp_from_numpy``):

  * ``G  = E H^-1 E'`` -- the (row-normalized) dual Gram matrix shared by
    every problem instance in a batch (E = [I_bounds; A]);
  * ``Dth theta + du/dl`` -- per-instance bounds, a single batched matvec;
  * ``U = u_off + Uth_off theta - HinvET lam`` -- primal recovery.

Formulating everything through ``H^-1`` (instead of the Cholesky square
root) also covers the non-symmetric H of game-theoretic MPC (DAQP's AVI
mode, reference src/setup.jl:12-13) with the identical iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import ACTIVE, BINARY, IMMUTABLE, MPQP, SOFT


@dataclass
class LDPData:
    """Host-side (float64) solver data; cast to the device dtype by the engine."""

    G: np.ndarray        # (m, m) normalized dual Gram matrix E H^-1 E'
    Dth: np.ndarray      # (m, nth) parametric bound map (normalized)
    du: np.ndarray       # (m,) upper offsets (normalized)
    dl: np.ndarray       # (m,) lower offsets (normalized)
    HinvET: np.ndarray   # (n, m) H^-1 E' (columns normalized)
    Uth_off: np.ndarray  # (n, nth) -H^-1 f_theta
    u_off: np.ndarray    # (n,)  -H^-1 f
    H: np.ndarray        # (n, n) original Hessian (for objective values)
    f: np.ndarray        # (n,)
    f_theta: np.ndarray  # (n, nth)
    is_eq: np.ndarray        # (m,) bool: always-active, sign-free multiplier
    is_immutable: np.ndarray  # (m,) bool: never activated
    is_soft: np.ndarray      # (m,) bool
    is_binary: np.ndarray    # (m,) bool
    up_finite: np.ndarray    # (m,) bool: upper bound is finite (branchable)
    lo_finite: np.ndarray    # (m,) bool: lower bound is finite (branchable)
    rho_soft: np.ndarray  # (m,) per-row proximal weight (0 for hard rows)
    scaling: np.ndarray  # (m,) row norms used for normalization
    prio: np.ndarray | None = None  # (m,) priority level per row

    @property
    def m(self) -> int:
        return self.G.shape[0]

    @property
    def n(self) -> int:
        return self.H.shape[0]

    @property
    def n_theta(self) -> int:
        return self.Dth.shape[1]


def qp2ldp(mpqp: MPQP, *, soft_weight: float = 1e6, normalize: bool = True,
           priority_separation: float = 1e4) -> LDPData:
    """Precompute the batched-LDP arrays for an mpQP.

    Rows are normalized by ||E_i H^-1/2|| (= sqrt diag G) so the dual Gram
    matrix has unit diagonal, matching the row scaling DAQP applies
    (reference src/codegen.jl:252-268).

    Prioritized soft constraints (the reference's break_points hierarchy,
    src/mpc2mpqp.jl:859-893 / DAQP hierarchical mode) are realized through
    per-level soft weights separated by ``priority_separation``: a
    higher-priority soft row carries a weight ``separation^levels`` larger,
    so violations resolve lexicographically in a single solve -- the
    batched-lockstep alternative to DAQP's sequential hierarchy.
    """
    H = mpqp.H
    if mpqp.is_symmetric:
        H = (H + H.T) / 2
    E = mpqp.extended_A()
    m, n = E.shape

    HinvET = np.linalg.solve(H, E.T)
    G = E @ HinvET
    Hinv_ftheta = np.linalg.solve(H, mpqp.f_theta)
    Hinv_f = np.linalg.solve(H, mpqp.f)
    Dth = mpqp.W + E @ Hinv_ftheta
    delta_d = E @ Hinv_f
    du = mpqp.bu + delta_d
    dl = mpqp.bl + delta_d

    diagG = np.diag(G).copy()
    scale = np.sqrt(np.maximum(diagG, 0.0))
    zero_rows = scale <= 1e-14
    scale = np.where(zero_rows, 1.0, scale)
    if normalize:
        Dinv = 1.0 / scale
        G = G * Dinv[:, None] * Dinv[None, :]
        Dth = Dth * Dinv[:, None]
        du = du * Dinv
        dl = dl * Dinv
        HinvET = HinvET * Dinv[None, :]
    else:
        scale = np.ones(m)

    senses = mpqp.senses
    is_eq = (senses & ACTIVE) != 0
    is_immutable = ((senses & IMMUTABLE) != 0) & ~is_eq
    is_immutable = is_immutable | zero_rows
    is_soft = (senses & SOFT) != 0
    is_binary = (senses & BINARY) != 0

    # per-row soft weights: priority levels get geometrically separated
    # weights (higher priority = larger weight = smaller rho)
    rho = np.where(is_soft, 1.0 / soft_weight, 0.0)
    levels = np.unique(mpqp.prio)
    if len(levels) > 1:
        n_lvl = len(levels)
        for li, lvl in enumerate(levels):
            rows = (mpqp.prio == lvl) & is_soft
            # lower prio value = higher priority = heavier weight
            w = soft_weight * priority_separation ** (n_lvl - 1 - li)
            rho[rows] = 1.0 / w

    # sentinel-aliasing guard (ADVICE r4): the solvers use 1e30 as the
    # finite "big" sentinel (TPU emulated f64 tops out near f32's 3.4e38
    # range, CLAUDE.md), so any legitimately reachable value >= ~1e30
    # would alias it and could be mis-pruned. condense.py sanitizes the
    # known INF-padding cases; warn on anything else that gets close.
    for name, arr, lim in (("du", du, 1e20), ("dl", dl, 1e20),
                           ("Dth", Dth, 1e25), ("f", mpqp.f, 1e25),
                           ("H", mpqp.H, 1e25)):
        finite = np.abs(arr[np.abs(arr) < 1e20]) if lim == 1e20 else np.abs(arr)
        if finite.size and float(np.max(finite)) > 1e25:
            import warnings

            warnings.warn(
                f"qp2ldp: |{name}| reaches {float(np.max(finite)):.2e}; "
                f"values near the solvers' 1e30 finite-infinity sentinel "
                f"can be mis-pruned (and overflow TPU emulated f64 near "
                f"3.4e38). Rescale the problem data.", stacklevel=2)

    return LDPData(
        G=G, Dth=Dth, du=du, dl=dl,
        HinvET=HinvET, Uth_off=-Hinv_ftheta, u_off=-Hinv_f,
        H=mpqp.H, f=mpqp.f, f_theta=mpqp.f_theta,
        is_eq=is_eq, is_immutable=is_immutable,
        is_soft=is_soft, is_binary=is_binary,
        up_finite=mpqp.bu < 1e20, lo_finite=mpqp.bl > -1e20,
        rho_soft=rho,
        scaling=scale,
        prio=np.asarray(mpqp.prio, dtype=int),
    )


def ldp_from_numpy(fields: dict[str, np.ndarray]) -> LDPData:
    """Build the port's ``LDPData`` from a field dict of NumPy arrays, e.g.
    ``vars(ldp)`` of the JAX package's ``LDPData``, so that both packages
    solve identical data."""
    names = LDPData.__dataclass_fields__
    unknown = set(fields) - set(names)
    if unknown:
        raise ValueError(f"unknown LDPData fields: {sorted(unknown)}")
    return LDPData(**{k: None if v is None else np.array(v) for k, v in fields.items()})


# Maximum m for which the working-set inverse cache is enumerated (2^m
# inverses of m x m matrices; 12 -> 4096 * 144 floats ~ 4.7 MB in f64).
SUBSET_CACHE_MAX_M = 12


def precompute_subset_inverses(ldp: LDPData) -> np.ndarray:
    """Inverse of every masked working-set system, indexed by the active-set
    bitmask: out[mask] = (act*G_solve*act' + diag(~act))^-1.

    The masked inverse has the same masked structure, so each dual
    active-set iteration on device collapses to one gather + one matvec --
    the TPU-lockstep replacement for DAQP's recursive LDL' up/downdates
    (speed-of-light path for small m; larger problems use the batched
    masked Cholesky path)."""
    m = ldp.m
    if m > SUBSET_CACHE_MAX_M:
        raise ValueError(f"subset cache limited to m <= {SUBSET_CACHE_MAX_M}")
    G_solve = ldp.G + np.diag(np.asarray(ldp.rho_soft, dtype=np.float64))
    out = np.empty((1 << m, m, m))
    out[0] = np.eye(m)
    for mask in range(1, 1 << m):
        act = np.array([(mask >> i) & 1 for i in range(m)], dtype=bool)
        M = np.where(act[:, None] & act[None, :], G_solve, 0.0) + np.diag(~act)
        try:
            out[mask] = np.linalg.inv(M)
        except np.linalg.LinAlgError:
            out[mask] = np.linalg.pinv(M)  # degenerate set: least-norm iterate
    return out
