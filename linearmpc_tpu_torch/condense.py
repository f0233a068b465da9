"""Condensation compiler: MPC specification -> dense multi-parametric QP.

This is the offline "compiler" of the framework (reference src/mpc2mpqp.jl).
It runs once per problem on the host in NumPy float64 and must be
numerically identical to the reference semantics; the resulting ``MPQP``
is then lowered to batched LDP arrays for the GPU solver (ops/ldp.py).
Carried over unchanged from ``linearmpc_tpu/condense.py``.

Resulting problem (reference src/mpc2mpqp.jl:612-647):

    min  0.5 U'HU + (f + f_theta theta)'U
    s.t. bl + W theta <= [I; A] U <= bu + W theta

with theta = [x0; r; d; u_prev; p] (components present per settings).

Time steps ``ks`` in constraints are 1-based: k=1 is the initial state,
k=2..Np+1 the predicted states, matching the reference convention.
"""

from __future__ import annotations

import warnings

import numpy as np

from .robust import constraint_tightening
from .types import (
    ACTIVE,
    BINARY,
    EQUALITY,
    IMMUTABLE,
    SOFT,
    DenseConstraints,
    DenseObjective,
    MPQP,
    MPCWeights,
)
from .utils.linalg import matrixify


def _iszero(a) -> bool:
    return a is None or np.size(a) == 0 or not np.any(np.asarray(a))


# ---------------------------------------------------------------------------
# Prediction matrices
# ---------------------------------------------------------------------------

def state_predictor(F, G, Np: int, Nc: int):
    """Build Phi, Gamma with X = Phi x0 + Gamma U, where X stacks x_0..x_Np
    and U stacks u_0..u_{Nc-1}; inputs are held (u_i = u_{Nc-1}) beyond the
    control horizon (reference src/mpc2mpqp.jl:20-46)."""
    nx, nu = G.shape
    Gamma = np.zeros(((Np + 1) * nx, Nc * nu))
    Phi = np.zeros(((Np + 1) * nx, nx))
    Phi[:nx, :] = np.eye(nx)

    Gtot = G.copy()
    Ftot = F.copy()
    for i in range(1, Nc + 1):
        for j in range(0, Nc - i + 1):
            Gamma[(i + j) * nx : (i + j + 1) * nx, j * nu : (j + 1) * nu] = Gtot
        Phi[i * nx : (i + 1) * nx, :] = Ftot
        if i == Nc:
            break
        Ftot = Ftot @ F
        Gtot = F @ Gtot

    for i in range(Nc + 1, Np + 1):
        Gamma[nx * i : nx * (i + 1), :] = F @ Gamma[nx * (i - 1) : nx * i, :]
        Gamma[nx * i : nx * (i + 1), -nu:] += G
        Phi[i * nx : (i + 1) * nx, :] = F @ Phi[nx * (i - 1) : nx * i, :]
    return Phi, Gamma


def disturbance_predictor(F, E, Np: int):
    """Psi with X_disturbance = Psi * vec(d_0..d_{Np-1})
    (reference src/mpc2mpqp.jl:48-58)."""
    nx, nd = E.shape
    Psi = np.zeros(((Np + 1) * nx, Np * nd))
    for k in range(1, Np + 1):
        Psi[k * nx : (k + 1) * nx, :] = F @ Psi[(k - 1) * nx : k * nx, :]
        Psi[k * nx : (k + 1) * nx, (k - 1) * nd : k * nd] += E
    return Psi


def disturbance_preview_predictor(mpc, F):
    nd = mpc.model.nd
    nxe = F.shape[0]
    if nd == 0:
        return np.zeros(((mpc.Np + 1) * nxe, 0))
    E = np.vstack([mpc.model.Gd, np.zeros((nxe - mpc.model.nx, nd))])
    return disturbance_predictor(F, E, mpc.Np)


# ---------------------------------------------------------------------------
# Parameter bookkeeping
# ---------------------------------------------------------------------------

def get_affine_parameter_base_dim(mpc) -> int:
    """Per-stage width of the generalized parameter p
    (reference src/utils.jl:207-216)."""
    if mpc.mpqp_issetup:
        if mpc.settings.parameter_preview:
            return 0 if mpc.np == 0 else mpc.np // mpc.Np
        return mpc.np
    dims = [mpc.weights.Ex.shape[1], mpc.weights.Eu.shape[1]]
    dims += [c.Ap.shape[1] if c.Ap.ndim == 2 else 0 for c in mpc.constraints]
    dims += [w.Ex.shape[1] for (w, _) in mpc.objectives]
    dims += [w.Eu.shape[1] for (w, _) in mpc.objectives]
    return max(dims) if dims else 0


def get_parameter_dims(mpc):
    """(nx, nr, nd, nuprev, np) of theta (reference src/mpc2mpqp.jl:147-164).
    Uses stored values once the mpQP is set up, so the QP and the runtime
    parameter vector stay consistent."""
    if mpc.mpqp_issetup:
        return mpc.model.nx, mpc.nr, mpc.nd, mpc.nuprev, mpc.np
    nr = mpc.model.ny if mpc.settings.reference_tracking else 0
    if mpc.settings.reference_preview and not mpc.settings.reference_condensation and nr > 0:
        nr = nr * mpc.Np
    nd = mpc.model.nd
    if mpc.settings.disturbance_preview and nd > 0:
        nd = nd * mpc.Np
    nuprev = (
        mpc.model.nu
        if (not _iszero(mpc.weights.Rr)) or any(not _iszero(c.Aup) for c in mpc.constraints)
        else 0
    )
    np_ = get_affine_parameter_base_dim(mpc) * (mpc.Np if mpc.settings.parameter_preview else 1)
    return mpc.model.nx, nr, nd, nuprev, np_


def get_parameter_names(mpc):
    """Human-readable names of the entries of theta
    (reference src/mpc2mpqp.jl:166-202)."""
    nx, nr, nd, nuprev, np_ = get_parameter_dims(mpc)
    names = list(mpc.model.labels.x)
    if nr > 0:
        if mpc.settings.reference_preview and not mpc.settings.reference_condensation:
            for k in range(mpc.Np):
                names += [f"{y}r_{k}" for y in mpc.model.labels.y]
        else:
            names += [f"{y}r" for y in mpc.model.labels.y]
    if nd > 0:
        if mpc.settings.disturbance_preview:
            for k in range(mpc.Np):
                names += [f"{d}_{k}" for d in mpc.model.labels.d]
        else:
            names += list(mpc.model.labels.d)
    if nuprev > 0:
        names += [f"{u}p" for u in mpc.model.labels.u]
    if np_ > 0:
        np_base = get_affine_parameter_base_dim(mpc)
        if mpc.settings.parameter_preview:
            for k in range(mpc.Np):
                names += [f"p{i + 1}_{k}" for i in range(np_base)]
        else:
            names += [f"p{i + 1}" for i in range(np_base)]
    return names


def _take_cols(W, start, length):
    if length == 0:
        return np.zeros((W.shape[0], 0))
    return W[:, start : start + length]


def insert_preview_parameter_blocks(mpc, W, Wr, Wd):
    """Splice preview-specific W-blocks into the [x | r | d | rest] column
    layout of the parameter matrix (reference src/mpc2mpqp.jl:70-92)."""
    nx = mpc.model.nx
    nr_base = 0 if mpc.settings.reference_preview else mpc.nr
    nd_base = 0 if mpc.settings.disturbance_preview else mpc.nd

    idx = nx + nr_base + nd_base
    parts = [_take_cols(W, 0, nx)]

    if mpc.settings.reference_preview and Wr.shape[1] > 0:
        parts.append(Wr)
    else:
        parts.append(_take_cols(W, nx, nr_base))

    if mpc.settings.disturbance_preview and Wd.shape[1] > 0:
        parts.append(Wd)
    else:
        parts.append(_take_cols(W, nx + nr_base, nd_base))

    parts.append(_take_cols(W, idx, W.shape[1] - idx))
    return np.hstack(parts)


def disturbance_preview_direct(A, ks, Np, nd):
    """Direct Ad d_k terms of stage constraints under disturbance preview
    (reference src/mpc2mpqp.jl:94-107)."""
    A = np.atleast_2d(A)
    m = A.shape[0]
    W = np.zeros((m * len(ks), nd * Np))
    if A.size == 0 or nd == 0 or not np.any(A):
        return W
    for i, k in enumerate(ks):
        if 2 <= k <= Np + 1:
            W[i * m : (i + 1) * m, (k - 2) * nd : (k - 1) * nd] = -A
    return W


def parameter_preview_direct(mpc, A, ks, Np, np_base):
    """Direct Ap p_k terms of stage constraints
    (reference src/mpc2mpqp.jl:125-143)."""
    A = np.atleast_2d(A)
    m = A.shape[0]
    ncols = np_base * Np if mpc.settings.parameter_preview else np_base
    W = np.zeros((m * len(ks), ncols))
    if A.size == 0 or np_base == 0 or not np.any(A):
        return W
    for i, k in enumerate(ks):
        if 1 <= k <= Np + 1:
            if mpc.settings.parameter_preview:
                col_id = min(k, Np)
                W[i * m : (i + 1) * m, (col_id - 1) * np_base : col_id * np_base] = -A
            else:
                W[i * m : (i + 1) * m, :np_base] = -A
    return W


def stage_parameter_matrix(mpc, A, N):
    if mpc.settings.parameter_preview:
        return np.kron(np.eye(N), A)
    return np.tile(A, (N, 1))


# ---------------------------------------------------------------------------
# Extended system / cost
# ---------------------------------------------------------------------------

def create_extended_system(mpc):
    """Augment the closed-loop dynamics with reference, measured-disturbance,
    previous-input, and affine-offset pseudo-states so that all tracking
    terms ride along the prediction matrices
    (reference src/mpc2mpqp.jl:649-690)."""
    F = mpc.model.F - mpc.model.G @ mpc.K
    G = mpc.model.G.copy()
    C = mpc.model.C.copy()
    nx, nr, nd, nuprev, np_ = get_parameter_dims(mpc)
    mpc.nr, mpc.nd, mpc.nuprev, mpc.np = nr, nd, nuprev, np_
    nu = mpc.model.nu
    ny = mpc.model.ny

    if nr > 0 and not mpc.settings.reference_preview:
        # reference as constant pseudo-state; output error y - r
        F = _blockdiag(F, np.eye(ny))
        G = np.vstack([G, np.zeros((ny, nu))])
        C = np.hstack([C, -np.eye(ny)])

    if mpc.model.nd > 0 and not mpc.settings.disturbance_preview:
        ndm = mpc.model.nd
        F = _blockdiag(F, np.eye(ndm))
        F[:nx, -ndm:] = mpc.model.Gd
        G = np.vstack([G, np.zeros((ndm, nu))])
        C = np.hstack([C, mpc.model.Dd])

    if nuprev > 0:
        # previous input as pseudo-state (for du penalties / Aup constraints)
        F = _blockdiag(F, np.zeros((nu, nu)))
        F[-nu:, :nx] = -mpc.K
        G = np.vstack([G, np.eye(nu)])
        nye, nxe = C.shape
        C = np.block([
            [C, np.zeros((nye, nu))],
            [mpc.K, np.zeros((nu, nxe - nx)), np.eye(nu)],
        ])

    if not _iszero(mpc.weights.R) and not _iszero(mpc.K):
        # expose u = v - Kx in the output so R penalizes the actual input
        C = np.vstack([C, np.hstack([mpc.K, np.zeros((nu, C.shape[1] - nx))])])

    if not _iszero(mpc.model.f_offset):
        F = _blockdiag(F, np.ones((1, 1)))
        F[:nx, -1] = mpc.model.f_offset
        G = np.vstack([G, np.zeros((1, nu))])
        C = np.hstack([C, np.zeros((C.shape[0], 1))])
    return F, G, C


def _blockdiag(A, B):
    out = np.zeros((A.shape[0] + B.shape[0], A.shape[1] + B.shape[1]))
    out[: A.shape[0], : A.shape[1]] = A
    out[A.shape[0] :, A.shape[1] :] = B
    return out


def create_extended_cost(mpc, weights: MPCWeights, uids=None) -> MPCWeights:
    """Extend the stage weights to the augmented state of
    ``create_extended_system`` (reference src/mpc2mpqp.jl:692-731)."""
    nu_model = mpc.model.nu
    uids = list(range(nu_model)) if uids is None else list(uids)
    nui = len(uids)

    Q = weights.Q.copy()
    R = weights.R.copy()
    Rr = weights.Rr.copy()
    S = weights.S.copy() if weights.S.size else np.zeros((mpc.model.nx, nui))
    Qf = Q.copy() if (_iszero(weights.Qf) and _iszero(weights.Qfx)) else weights.Qf.copy()
    nx, nr, nd, nuprev, np_ = get_parameter_dims(mpc)

    if nr > 0 and not mpc.settings.reference_preview:
        S = np.vstack([S, np.zeros((mpc.model.ny, nui))])

    if mpc.model.nd > 0 and not mpc.settings.disturbance_preview:
        S = np.vstack([S, np.zeros((mpc.model.nd, nui))])

    if nuprev > 0:
        Rrfull = np.zeros((nu_model, nu_model))
        Rrfull[np.ix_(uids, uids)] = Rr
        Q = _blockdiag(Q, Rrfull)
        Qf = _blockdiag(Qf, np.zeros((nu_model, nu_model)))
        S = np.vstack([S, -Rrfull[:, uids]])
        S[:nx, :] -= mpc.K[uids, :].T @ Rr
        R = R + Rr

    if not _iszero(R) and not _iszero(mpc.K):
        Rfull = np.zeros((nu_model, nu_model))
        Rfull[np.ix_(uids, uids)] = weights.R
        Q = _blockdiag(Q, Rfull)
        Qf = _blockdiag(Qf, np.zeros((nu_model, nu_model)))
        S[:nx, :] -= mpc.K[uids, :].T @ weights.R

    if not _iszero(mpc.model.f_offset):
        S = np.vstack([S, np.zeros((1, nui))])

    return MPCWeights(
        Q=Q, R=R, Rr=np.zeros((0, 0)), S=S, Qf=Qf, Qfx=np.zeros((0, 0)),
        Ex=weights.Ex, ex=weights.ex, Eu=weights.Eu, eu=weights.eu,
    )


# ---------------------------------------------------------------------------
# Objective assembly
# ---------------------------------------------------------------------------

def create_objective(mpc, F, Phi, Gamma, C, w: MPCWeights, nu: int, nx: int) -> DenseObjective:
    """Assemble H, f, f_theta, H_theta for the condensed QP
    (reference src/mpc2mpqp.jl:407-533). ``nu``/``nx`` are extended dims."""
    Q, R, S, Qf = w.Q, w.R, w.S, w.Qf
    N, Nc = mpc.Np, mpc.Nc
    ny = mpc.model.ny

    Q_full, Qf_full = Q[:ny, :ny], Qf[:ny, :ny]
    C_full = C[:ny, :]

    pos_Q = np.where(np.diag(Q) > 0)[0]  # drop zero/negative-weight outputs
    Qp = Q[np.ix_(pos_Q, pos_Q)]
    Cp = C[pos_Q, :]

    pos_Qf = np.where(np.diag(Qf) > 0)[0]
    Qfp = Qf[np.ix_(pos_Qf, pos_Qf)]
    Cf = C[pos_Qf, :]

    nxp, nrp, ndp, nup, npp = get_parameter_dims(mpc)

    # ==== u'Ru terms ====
    H = np.kron(np.eye(Nc), R)
    f = np.zeros(H.shape[0])
    H[-nu:, -nu:] += (N - Nc) * R  # held last input beyond Nc

    if not mpc.settings.reference_tracking and not _iszero(mpc.model.uo):
        Uo = np.tile(mpc.model.uo, Nc)
        f -= H @ Uo
        if not _iszero(mpc.K) and not _iszero(R):
            KR = np.vstack([-mpc.K.T @ R, np.zeros((nx - mpc.K.shape[1], nu))])
            KRtot = np.vstack([np.kron(np.eye(Nc), KR), np.zeros(((N - Nc + 1) * nx, Nc * nu))])
            KRtot[Nc * nx : N * nx, -nu:] = np.tile(KR, (N - Nc, 1))
            GKR = Gamma.T @ KRtot
            f -= (GKR + GKR.T) @ Uo

    # ==== (Cx)'Q(Cx) terms ====
    CQCtot = np.kron(np.eye(N + 1), Cp.T @ Qp @ Cp)
    CQCf = Cf.T @ Qfp @ Cf
    if mpc.weights.Qfx.size:
        CQCf[:nxp, :nxp] += mpc.weights.Qfx
    CQCtot[-nx:, -nx:] = CQCf

    H += Gamma.T @ CQCtot @ Gamma
    f_theta = Gamma.T @ CQCtot @ Phi
    H_theta = Phi.T @ CQCtot @ Phi
    if not mpc.settings.reference_tracking and not _iszero(mpc.model.xo):
        f -= Gamma.T @ CQCtot @ np.tile(np.concatenate([mpc.model.xo, np.zeros(nx - nxp)]), N + 1)

    # ==== x'Su terms ====
    if not _iszero(S):
        Stot = np.vstack([np.kron(np.eye(Nc), S), np.zeros(((N - Nc + 1) * nx, Nc * nu))])
        Stot[Nc * nx : N * nx, -nu:] = np.tile(S, (N - Nc, 1))
        GS = Gamma.T @ Stot
        H += GS + GS.T
        f_theta += Stot.T @ Phi

    # ==== reference / disturbance preview cost blocks ====
    if nrp > 0 and mpc.settings.reference_preview:
        f_theta, H_theta = ref_preview_cost(mpc, Gamma, C_full, Q_full, Qf_full, H, f_theta, H_theta)
    if ndp > 0 and mpc.settings.disturbance_preview:
        f_theta, H_theta = disturbance_preview_cost(mpc, F, Gamma, C_full, Q_full, Qf_full, f_theta, H_theta)

    # ==== generalized-parameter cost (Ex p + ex)'x + (Eu p + eu)'u ====
    np_base = get_affine_parameter_base_dim(mpc)
    nx_model = mpc.model.nx
    Ex = w.Ex if w.Ex.shape[1] > 0 else np.zeros((nx_model, np_base))
    ex = w.ex if w.ex.size else np.zeros(nx_model)
    Eu = w.Eu if w.Eu.shape[1] > 0 else np.zeros((nu, np_base))
    eu = w.eu if w.eu.size else np.zeros(nu)
    if Ex.shape != (nx_model, np_base):
        raise ValueError(f"Affine objective matrix Ex must have shape ({nx_model},{np_base})")
    if len(ex) != nx_model:
        raise ValueError(f"Affine objective vector ex must have length {nx_model}")
    if Eu.shape != (nu, np_base):
        raise ValueError(f"Affine objective matrix Eu must have shape ({nu},{np_base})")
    if len(eu) != nu:
        raise ValueError(f"Affine objective vector eu must have length {nu}")

    Umap = np.kron(np.vstack([np.eye(Nc), np.zeros((N - Nc, Nc))]), np.eye(nu))
    f += Umap.T @ np.tile(eu, N)

    x_selector = np.hstack([np.eye(nx_model), np.zeros((nx_model, nx - nx_model))])
    Xmap = np.kron(np.eye(N), x_selector)
    Gamma_x = Xmap @ Gamma[nx:, :]
    f += Gamma_x.T @ np.tile(ex, N)

    if npp > 0:
        Fp = Umap.T @ stage_parameter_matrix(mpc, Eu, N)
        Fp = Fp + Gamma_x.T @ stage_parameter_matrix(mpc, Ex, N)
        f_theta = np.hstack([f_theta, Fp])
        nth_current = H_theta.shape[0]
        H_theta = np.block([
            [H_theta, np.zeros((nth_current, npp))],
            [np.zeros((npp, nth_current + npp))],
        ])

    # ==== binary-control regularization (does not change the minimizer) ====
    # The reference uses the raw bound midpoint (src/mpc2mpqp.jl:510-512).
    # With an INF-padded bound (set_input_bounds fills missing entries
    # with +-1e30, matching src/setup.jl:42-43 -- the reference's own
    # invpend_contact example leaves one binary's umin unset) the raw
    # midpoint injects a +-5e29 linear cost, blowing the condensed
    # problem's scale to ~1e29 (products ~1e59: fine in native f64, but
    # past the ~3.4e38 range of the TPU's emulated f64, where it becomes
    # NaN and poisons the B&B). Minimizer-neutrality of the +-(u-mid)^2/2
    # term only requires the midpoint over bounds the optimizer can
    # attain, and an INF-clamped bound can never be attained (every
    # accepted incumbent must sit at a bound, and the B&B only ever pins
    # the finite side) -- so pin the midpoint to the finite side(s).
    fbin_part = np.zeros(mpc.model.nu)
    if len(mpc.binary_controls):
        bc = np.asarray(mpc.binary_controls, dtype=int)
        lo_b, up_b = mpc.umin[bc], mpc.umax[bc]
        lo_fin, up_fin = lo_b > -1e29, up_b < 1e29
        lo_eff = np.where(lo_fin, lo_b, np.where(up_fin, up_b, 0.0))
        up_eff = np.where(up_fin, up_b, np.where(lo_fin, lo_b, 0.0))
        fbin_part[bc] = (up_eff + lo_eff) / 2
    fbin = np.tile(fbin_part, Nc)
    f -= fbin
    H += np.diag((fbin != 0).astype(np.float64))

    # ==== collapse the constant-offset pseudo-state ====
    if not _iszero(mpc.model.f_offset):
        f += f_theta[:, -1]
        f_theta = f_theta[:, :-1]
        H_theta = H_theta[:-1, :-1]
    # h_offset enters like a constant reference shift r - h_offset
    if nrp > 0 and not _iszero(mpc.model.h_offset):
        if mpc.settings.reference_preview and not mpc.settings.reference_condensation:
            f -= f_theta[:, nxp : nxp + nrp] @ np.tile(mpc.model.h_offset, mpc.Np)
        else:
            f -= f_theta[:, nxp : nxp + nrp] @ mpc.model.h_offset

    return DenseObjective((H + H.T) / 2, f, f_theta, H_theta)


def ref_preview_cost(mpc, Gamma, C_full, Q_full, Qf_full, H, f_theta, H_theta):
    """Insert the time-varying-reference cost blocks into f_theta/H_theta
    (reference src/mpc2mpqp.jl:535-577)."""
    N, Nc = mpc.Np, mpc.Nc
    nu, ny = mpc.model.nu, mpc.model.ny
    nxp, nrp, ndp, nup, npp = get_parameter_dims(mpc)

    CQfull = np.kron(np.eye(N + 1), C_full.T @ Q_full)
    nxe = C_full.shape[1]
    CQfull[-nxe:, -Qf_full.shape[1]:] = C_full.T @ Qf_full
    Fr = -(Gamma.T @ CQfull)
    Fr = Fr[:, ny:]  # first reference (at k=0) is superfluous
    Hr = np.kron(np.eye(N), Q_full)
    Hr[-Q_full.shape[0]:, -Q_full.shape[1]:] = Qf_full
    if mpc.settings.reference_condensation:
        Is = np.tile(np.eye(ny), (N, 1))
        if mpc.settings.traj2setpoint.size == 0:
            if np.size(mpc.settings.condensation_weights) == 0:
                Wc = np.eye(nu * Nc)
                for i in range(nu):
                    Wc[i, i] = 1e6  # weight accuracy of the first control most
            else:
                Wc = matrixify(mpc.settings.condensation_weights)
            WinvHFr = Wc @ np.linalg.solve(H, Fr)
            mpc.traj2setpoint = np.linalg.lstsq(WinvHFr @ Is, WinvHFr, rcond=None)[0]
        else:
            mpc.traj2setpoint = mpc.settings.traj2setpoint
        Fr = Fr @ Is
        Hr = Is.T @ Hr @ Is
    f_theta = np.hstack([f_theta[:, :nxp], Fr, f_theta[:, nxp:]])

    tail = H_theta.shape[0] - nxp
    H_theta = np.block([
        [H_theta[:nxp, :nxp], np.zeros((nxp, nrp)), H_theta[:nxp, nxp:]],
        [np.zeros((nrp, nxp)), Hr, np.zeros((nrp, tail))],
        [H_theta[nxp:, :nxp], np.zeros((tail, nrp)), H_theta[nxp:, nxp:]],
    ])
    return f_theta, H_theta


def disturbance_preview_cost(mpc, F, Gamma, C_full, Q_full, Qf_full, f_theta, H_theta):
    """Insert the disturbance-preview cost blocks
    (reference src/mpc2mpqp.jl:579-604)."""
    N = mpc.Np
    nxp, nrp, ndp, _, _ = get_parameter_dims(mpc)
    nxe = F.shape[0]

    Psi = disturbance_preview_predictor(mpc, F)
    Psi_future = Psi[nxe:, :]
    Gamma_future = Gamma[nxe:, :]
    CY = np.kron(np.eye(N), C_full)
    Gamma_y = CY @ Gamma_future
    Yd = CY @ Psi_future + np.kron(np.eye(N), mpc.model.Dd[: C_full.shape[0], :])

    Qy = np.kron(np.eye(N), Q_full)
    Qy[-Qf_full.shape[0]:, -Qf_full.shape[1]:] = Qf_full

    Fd = Gamma_y.T @ Qy @ Yd
    Hd = Yd.T @ Qy @ Yd
    split = nxp + nrp
    tail = H_theta.shape[0] - split

    f_theta = np.hstack([f_theta[:, :split], Fd, f_theta[:, split:]])
    H_theta = np.block([
        [H_theta[:split, :split], np.zeros((split, ndp)), H_theta[:split, split:]],
        [np.zeros((ndp, split)), Hd, np.zeros((ndp, tail))],
        [H_theta[split:, :split], np.zeros((tail, ndp)), H_theta[split:, split:]],
    ])
    return f_theta, H_theta


def create_variational_objective(mpc, Phi, Gamma, Cp) -> DenseObjective:
    """Multi-objective (game-theoretic / Nash) condensation: one objective per
    player over a partition of the controls, yielding a non-symmetric H
    solved as an affine variational inequality
    (reference src/mpc2mpqp.jl:900-950)."""
    N, Nc = mpc.Np, mpc.Nc
    nu = mpc.model.nu

    weights = [create_extended_cost(mpc, w, uids) for (w, uids) in mpc.objectives]
    uids_list = [list(uids) for (_, uids) in mpc.objectives]

    n_players = len(mpc.objectives)
    uids_sorted = sorted(u for uids in uids_list for u in uids)
    if len(uids_sorted) != nu or any(uids_sorted[i] != i for i in range(nu)):
        raise ValueError("The controls have to be fully partitioned")

    nU, nth = Gamma.shape[1], Phi.shape[1]
    Gammas, Uids = [], []
    for uids in uids_list:
        Uid = np.concatenate([np.asarray(uids) + k * nu for k in range(nU // nu)])
        Gammas.append(Gamma[:, Uid])
        Uids.append(Uid)

    H = np.zeros((nU, nU))
    f_theta = np.zeros((nU, nth))
    for i in range(n_players):
        nui = len(uids_list[i])
        CQCtot = np.kron(np.eye(N), Cp.T @ weights[i].Q @ Cp)
        CQCtot = _blockdiag(CQCtot, Cp.T @ weights[i].Qf @ Cp)
        for j in range(n_players):
            H[np.ix_(Uids[i], Uids[j])] = Gammas[i].T @ CQCtot @ Gammas[j]
            if i == j:
                H[np.ix_(Uids[i], Uids[i])] += np.kron(np.eye(Nc), weights[i].R)
                tail = Uids[i][-nui:]
                H[np.ix_(tail, tail)] += (N - Nc) * weights[i].R
        f_theta[Uids[i], :] = Gammas[i].T @ CQCtot @ Phi

        Stot = np.vstack([np.kron(np.eye(Nc), weights[i].S), np.zeros(((N - Nc + 1) * nth, Nc * nui))])
        Stot[Nc * nth : N * nth, -nui:] = np.tile(weights[i].S, (N - Nc, 1))
        GS = Gammas[i].T @ Stot
        H[np.ix_(Uids[i], Uids[i])] += GS + GS.T
        f_theta[Uids[i], :] += Stot.T @ Phi
    return DenseObjective(H, np.zeros(nU), f_theta, np.zeros((0, 0)))


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------

def create_controlbounds(mpc, F, Gamma, Phi):
    """Control bounds lb <= u_k <= ub over the control horizon, with
    prestabilizing-feedback coupling (I - K Gamma) and robust tightening
    (reference src/mpc2mpqp.jl:206-245)."""
    nu, nx, Nb = mpc.model.nu, mpc.model.nx, mpc.Nc
    _, _, _, _, np_ = get_parameter_dims(mpc)
    nxe = sum(get_parameter_dims(mpc)) - np_
    if mpc.settings.reference_preview:
        nxe -= mpc.nr
    if mpc.settings.disturbance_preview:
        nxe -= mpc.nd
    if not _iszero(mpc.model.f_offset):
        nxe += 1

    # u_k = v_k - K x_k  =>  (I - K Gamma) V - K Phi x0
    Kfull = np.kron(np.eye(Nb), np.hstack([mpc.K, np.zeros((nu, nxe - nx))]))
    if not _iszero(mpc.K):
        A = np.eye(Nb * nu) - Kfull @ Gamma[: Nb * nxe, : Nb * nu]
        W = Kfull @ Phi[: Nb * nxe, :]
    else:
        A = np.zeros((0, mpc.Nc * nu))
        W = np.zeros((Nb * nu, nxe))

    ub = np.tile(mpc.umax, Nb)
    lb = np.tile(mpc.umin, Nb)

    if not _iszero(mpc.K) and (not _iszero(mpc.model.wmin) or not _iszero(mpc.model.wmax)):
        FK = mpc.model.F - mpc.model.G @ mpc.K
        ut, lt = constraint_tightening(-mpc.K, FK, range(1, Nb + 1), mpc.model.wmin, mpc.model.wmax, mpc.dx0)
        ub = ub - ut
        lb = lb + lt

    rows = W.shape[0]
    Wr = np.zeros((rows, mpc.nr)) if mpc.settings.reference_preview else np.zeros((rows, 0))
    if mpc.settings.disturbance_preview:
        Wd = Kfull @ disturbance_preview_predictor(mpc, F)[: Nb * nxe, :]
    else:
        Wd = np.zeros((rows, 0))
    W = insert_preview_parameter_blocks(mpc, W, Wr, Wd)
    if np_ > 0:
        W = np.hstack([W, np.zeros((W.shape[0], np_))])
    return A, ub, lb, W


def create_general_constraints(mpc, F, Gamma, Phi):
    """Kron-expand stage constraints over their time steps ks
    (reference src/mpc2mpqp.jl:249-354)."""
    Np, Nc = mpc.Np, mpc.Nc
    nu, nx = mpc.model.nu, mpc.model.nx
    _, _, _, _, np_ = get_parameter_dims(mpc)

    nxe = sum(get_parameter_dims(mpc)) - np_
    if mpc.settings.reference_preview:
        nxe -= mpc.nr
        nrx = 0
    else:
        nrx = mpc.nr
    if mpc.settings.disturbance_preview:
        nxe -= mpc.nd
        ndx = 0
    else:
        ndx = mpc.nd
    if not _iszero(mpc.model.f_offset):
        nxe += 1

    ubtot = np.zeros(0)
    lbtot = np.zeros(0)
    Axtot = np.zeros((0, nxe * (Np + 1)))
    Autot = np.zeros((0, nu * Nc))
    issoft = np.zeros(0, dtype=bool)
    isbinary = np.zeros(0, dtype=bool)
    prios = np.zeros(0, dtype=int)
    Wd_direct = np.zeros((0, mpc.nd if mpc.settings.disturbance_preview else 0))
    np_base = get_affine_parameter_base_dim(mpc)
    Wp_direct = np.zeros((0, np_))

    eyeX = np.eye(Np + 1)
    eyeU = np.vstack([np.eye(Nc), np.zeros((1 + Np - Nc, Nc))])  # held input -> no Au beyond Nc

    tighten = (not _iszero(mpc.model.wmin)) or (not _iszero(mpc.model.wmax)) or (not _iszero(mpc.dx0))

    for c in mpc.constraints:
        mi = c.Au.shape[0]
        kmax = Np + 1 if _iszero(c.Au) else Np
        ks = [k for k in c.ks if k <= kmax]
        Ni = len(ks)

        Ax = c.Ax - c.Au @ mpc.K
        Ar = np.zeros((mi, nrx)) if (c.Ar.size == 0 or nrx == 0) else c.Ar
        Ad = np.zeros((mi, ndx)) if (c.Ad.size == 0 or ndx == 0) else c.Ad
        Aup = np.zeros((mi, mpc.nuprev)) if c.Aup.size == 0 else c.Aup
        Ah = np.zeros((mi, 0)) if _iszero(mpc.model.f_offset) else np.zeros((mi, 1))

        rows_u = [k - 1 for k in ks]
        Autot = np.vstack([Autot, np.kron(eyeU[rows_u, :], c.Au)])
        Axtot = np.vstack([Axtot, np.kron(eyeX[rows_u, :], np.hstack([Ax, Ar, Ad, Aup, Ah]))])

        ub_blk = np.tile(c.ub, Ni)
        lb_blk = np.tile(c.lb, Ni)
        if tighten:
            FK = mpc.model.F - mpc.model.G @ mpc.K
            ut, lt = constraint_tightening(Ax, FK, ks, mpc.model.wmin, mpc.model.wmax, mpc.dx0)
            ub_blk = ub_blk - ut
            lb_blk = lb_blk + lt
        ubtot = np.concatenate([ubtot, ub_blk])
        lbtot = np.concatenate([lbtot, lb_blk])

        issoft = np.concatenate([issoft, np.full(mi * Ni, c.soft)])
        isbinary = np.concatenate([isbinary, np.full(mi * Ni, c.binary)])
        prios = np.concatenate([prios, np.full(mi * Ni, c.prio)])
        if mpc.settings.disturbance_preview:
            Ad_src = np.zeros((mi, mpc.model.nd)) if c.Ad.size == 0 else c.Ad
            Wd_direct = np.vstack([Wd_direct, disturbance_preview_direct(Ad_src, ks, Np, mpc.model.nd)])
        if np_ > 0:
            Ap_src = np.zeros((mi, np_base)) if c.Ap.size == 0 else c.Ap
            Wp_direct = np.vstack([Wp_direct, parameter_preview_direct(mpc, Ap_src, ks, Np, np_base)])

    A = Axtot @ Gamma + Autot
    W = -Axtot @ Phi

    Wr = np.zeros((W.shape[0], 0))
    if mpc.settings.reference_tracking and mpc.settings.reference_preview:
        Wr = np.zeros((0, mpc.nr))
        if mpc.settings.reference_condensation:
            for c in mpc.constraints:
                mi = c.Au.shape[0]
                ks = [k for k in c.ks if k <= Np]
                Ar = np.zeros((mi, mpc.nr)) if c.Ar.size == 0 else c.Ar
                Wr = np.vstack([Wr, np.tile(-Ar, (len(ks), 1))])
        else:
            eye_r = np.eye(mpc.Np)
            for c in mpc.constraints:
                mi = c.Au.shape[0]
                Ni = sum(1 for k in c.ks if k <= Np)
                if c.Ar.size == 0:
                    Wrn = np.zeros((mi * Ni, mpc.nr))
                else:
                    # constraint at step k sees reference r_{k-1}
                    krows = [k - 2 for k in c.ks if 2 <= k <= Np]
                    Wrn = np.kron(eye_r[krows, :], -c.Ar)
                    if Wrn.shape[0] < mi * Ni:
                        Wrn = np.vstack([np.zeros((mi * Ni - Wrn.shape[0], mpc.nr)), Wrn])
                Wr = np.vstack([Wr, Wrn])

    if mpc.settings.disturbance_preview:
        Wd = -Axtot @ disturbance_preview_predictor(mpc, F) + Wd_direct
    else:
        Wd = np.zeros((W.shape[0], 0))
    W = insert_preview_parameter_blocks(mpc, W, Wr, Wd)

    if np_ > 0:
        W = np.hstack([W, Wp_direct])

    return A, ubtot, lbtot, W, issoft, isbinary, prios


def create_constraints(mpc, F, Phi, Gamma) -> DenseConstraints:
    """Stack control bounds (simple rows) and general constraints into
    A U <= b + W theta form (reference src/mpc2mpqp.jl:358-402)."""
    n = Gamma.shape[1]
    nth = sum(get_parameter_dims(mpc))
    if not _iszero(mpc.model.f_offset):
        nth += 1

    if len(mpc.umax):
        A, bu, bl, W = create_controlbounds(mpc, F, Gamma, Phi)
        issoft = np.zeros(n, dtype=bool)
        prios = np.zeros(n, dtype=int)
        isbinary_single = np.zeros(mpc.model.nu, dtype=bool)
        if len(mpc.binary_controls):
            isbinary_single[np.asarray(mpc.binary_controls, dtype=int)] = True
        isbinary = np.tile(isbinary_single, mpc.Nc)
        if mpc.Nc_binary >= 0:
            isbinary[mpc.Nc_binary * mpc.model.nu :] = False
    else:
        A = np.zeros((0, n))
        bu, bl, W = np.zeros(0), np.zeros(0), np.zeros((0, nth))
        issoft = np.zeros(0, dtype=bool)
        isbinary = np.zeros(0, dtype=bool)
        prios = np.zeros(0, dtype=int)

    if len(mpc.constraints):
        Ag, bug, blg, Wg, softg, binaryg, priog = create_general_constraints(mpc, F, Gamma, Phi)
        prios = np.concatenate([prios, priog])
        issoft = np.concatenate([issoft, softg])
        isbinary = np.concatenate([isbinary, binaryg])
        bu = np.concatenate([bu, bug])
        bl = np.concatenate([bl, blg])
        A = np.vstack([A, Ag])
        W = np.vstack([W, Wg])

    # fold the constant-offset column into the bounds
    if not _iszero(mpc.model.f_offset):
        bu = bu + W[:, -1]
        bl = bl + W[:, -1]
        W = W[:, :-1]

    return DenseConstraints(A, bu, bl, W, issoft, isbinary, prios)


# ---------------------------------------------------------------------------
# Move blocking
# ---------------------------------------------------------------------------

def apply_move_block(mpc, obj: DenseObjective, c: DenseConstraints):
    """Contract the decision vector through the blocking map T and drop
    superfluous control-bound rows (reference src/mpc2mpqp.jl:830-857)."""
    nu = mpc.model.nu
    nu_bounds = len(mpc.umax)

    nUold = nu * mpc.Nc
    nUnew = sum(len(mb) for mb in mpc.move_blocks)

    T = np.zeros((nUold, nUnew))
    counter = list(range(nu))  # 0-based first-row index per input
    keep: list[int] = []
    new_id = 0
    max_len = max(len(mb) for mb in mpc.move_blocks)
    for p in range(max_len):
        for iu, mb in enumerate(mpc.move_blocks):
            if len(mb) <= p:
                continue
            block = mb[p] if p != len(mb) - 1 else 1  # last block clipped: held anyway
            rows = [counter[iu] + nu * j for j in range(block)]
            T[rows, new_id] = 1
            if counter[iu] < nu_bounds * mpc.Nc:
                keep.append(counter[iu])
            counter[iu] += nu * block
            new_id += 1
    new_obj = DenseObjective(T.T @ obj.H @ T, T.T @ obj.f, T.T @ obj.f_theta, obj.H_theta)

    keep += list(range(nu_bounds * mpc.Nc, len(c.bu)))
    keep = np.asarray(keep, dtype=int)
    Anew = (c.A[keep, :] @ T) if not _iszero(mpc.K) else c.A @ T
    new_c = DenseConstraints(
        Anew, c.bu[keep], c.bl[keep], c.W[keep, :], c.issoft[keep], c.isbinary[keep], c.prio[keep]
    )
    return new_obj, new_c


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------

def sort_constraints(c: DenseConstraints) -> DenseConstraints:
    """Stable sort of general rows by priority (reference src/mpc2mpqp.jl:859-866)."""
    ns = len(c.prio) - c.A.shape[0]
    order = np.argsort(c.prio[ns:], kind="stable")
    Anew = c.A[order, :]
    full = np.concatenate([np.arange(ns), order + ns])
    return DenseConstraints(
        Anew, c.bu[full], c.bl[full], c.W[full, :], c.issoft[full], c.isbinary[full], c.prio[full]
    )


def remove_redundant(c: DenseConstraints) -> DenseConstraints:
    """Normalize general rows to unique half-planes and fold single-coefficient
    rows into the matching simple bound (reference src/mpc2mpqp.jl:733-773)."""
    A = c.A.copy()
    bu, bl, W = c.bu.copy(), c.bl.copy(), c.W.copy()
    issoft, isbinary, prio = c.issoft, c.isbinary, c.prio
    nsimple = len(bu) - A.shape[0]
    keep = list(range(nsimple))
    norm_factors = [1.0] * nsimple
    for i in range(A.shape[0]):
        a = A[i, :]
        row_id = nsimple + i
        norm_factor = np.linalg.norm(a)
        if norm_factor > 1e-10:
            nz = np.where(np.abs(a) > 1e-12)[0]
            nz_id = nz[0]
            if a[nz_id] < 0:  # unique half-planes: make first nonzero positive
                A[i, :] = -a + 0.0
                bu[row_id], bl[row_id] = -bl[row_id], -bu[row_id]
                W[row_id, :] = -W[row_id, :] + 0.0
            if len(nz) == 1:  # simple bound in disguise
                if nz_id < nsimple and prio[nz_id] == prio[row_id]:
                    if issoft[nz_id] == issoft[row_id] and isbinary[nz_id] == isbinary[row_id]:
                        if not np.any(W[row_id, :] - W[nz_id, :]):
                            bu[nz_id] = min(bu[nz_id], bu[row_id] / norm_factor)
                            bl[nz_id] = max(bl[nz_id], bl[row_id] / norm_factor)
                            continue
            keep.append(row_id)
            norm_factors.append(1.0 / norm_factor)
    if len(keep) < len(bu):
        keep = np.asarray(keep, dtype=int)
        nf = np.asarray(norm_factors)
        keepA = keep[nsimple:] - nsimple
        A = A[keepA, :] * nf[nsimple:, None]
        bu, bl, W = bu[keep] * nf, bl[keep] * nf, W[keep, :] * nf[:, None]
        issoft, isbinary, prio = issoft[keep], isbinary[keep], prio[keep]
    return DenseConstraints(A, bu, bl, W, issoft, isbinary, prio)


def find_duplicate_rows(A: np.ndarray, digits: int = 6):
    """Group row indices by their values rounded to ``digits`` decimals,
    preserving first-occurrence order (reference src/mpc2mpqp.jl:775-791)."""
    groups: dict[bytes, list[int]] = {}
    order: list[bytes] = []
    for i in range(A.shape[0]):
        key = np.round(A[i, :], digits).tobytes()
        if key in groups:
            groups[key].append(i)
        else:
            groups[key] = [i]
            order.append(key)
    return [groups[k] for k in order]


def remove_duplicate(c: DenseConstraints) -> DenseConstraints:
    """Merge duplicate general rows, intersecting their bounds
    (reference src/mpc2mpqp.jl:793-828)."""
    A, bu, bl, W = c.A, c.bu, c.bl, c.W
    issoft, isbinary, prio = c.issoft, c.isbinary, c.prio
    nsimple = len(bu) - A.shape[0]
    idsA = slice(nsimple, len(bu))
    Aext = np.hstack([
        A, W[idsA, :], issoft[idsA, None].astype(float),
        isbinary[idsA, None].astype(float), prio[idsA, None].astype(float),
    ])
    dup_map = find_duplicate_rows(Aext)
    if len(dup_map) == A.shape[0]:
        return c

    ng = len(dup_map)
    A_new = np.zeros((ng, A.shape[1]))
    bu_new = np.concatenate([bu[:nsimple], np.zeros(ng)])
    bl_new = np.concatenate([bl[:nsimple], np.zeros(ng)])
    W_new = np.vstack([W[:nsimple, :], np.zeros((ng, W.shape[1]))])
    soft_new = np.concatenate([issoft[:nsimple], np.zeros(ng, dtype=bool)])
    bin_new = np.concatenate([isbinary[:nsimple], np.zeros(ng, dtype=bool)])
    prio_new = np.concatenate([prio[:nsimple], np.zeros(ng, dtype=prio.dtype)])
    for i, ids in enumerate(dup_map):
        rep = ids[0]
        full_ids = [j + nsimple for j in ids]
        A_new[i, :] = A[rep, :]
        bu_new[nsimple + i] = bu[full_ids].min()
        bl_new[nsimple + i] = bl[full_ids].max()
        W_new[nsimple + i, :] = W[rep + nsimple, :]
        soft_new[nsimple + i] = issoft[rep + nsimple]
        bin_new[nsimple + i] = isbinary[rep + nsimple]
        prio_new[nsimple + i] = prio[rep + nsimple]
    return DenseConstraints(A_new, bu_new, bl_new, W_new, soft_new, bin_new, prio_new)


# ---------------------------------------------------------------------------
# MPQP assembly & entry point
# ---------------------------------------------------------------------------

def make_mpqp(obj: DenseObjective, c: DenseConstraints) -> MPQP:
    """Assign constraint senses and priority break points
    (reference src/mpc2mpqp.jl:868-899)."""
    m = len(c.bu)
    senses = np.zeros(m, dtype=np.int32)
    for i in range(m):
        if c.bu[i] > 1e20 and c.bl[i] < -1e20:
            senses[i] = IMMUTABLE
        elif abs(c.bu[i] - c.bl[i]) < 1e-12:
            senses[i] = EQUALITY
    senses[c.issoft] += SOFT
    senses[c.isbinary] += BINARY

    bu = np.clip(c.bu, -1e30, 1e30)
    bl = np.clip(c.bl, -1e30, 1e30)

    # first-occurrence boundaries of each priority level
    break_points: list[int] = []
    seen = set()
    for i, p in enumerate(c.prio):
        if p not in seen:
            seen.add(p)
            break_points.append(i)
    break_points = break_points[1:]
    if break_points:
        break_points.append(m)

    H = obj.H
    is_symmetric = bool(np.allclose(H, H.T, rtol=1e-9))
    return MPQP(
        H=H, f=obj.f, H_theta=obj.H_theta, f_theta=obj.f_theta,
        A=c.A, bu=bu, bl=bl, W=c.W,
        senses=senses, prio=np.asarray(c.prio, dtype=np.int32),
        break_points=np.asarray(break_points, dtype=np.int32),
        has_binaries=bool(np.any(c.isbinary)), is_symmetric=is_symmetric,
    )


def mpc2mpqp(mpc) -> MPQP:
    """Condense an MPC problem into a dense mpQP
    (reference src/mpc2mpqp.jl:612-647)."""
    if (
        mpc.settings.reference_tracking
        and not _iszero(mpc.model.uo)
        and not _iszero(mpc.weights.R)
    ):
        warnings.warn(
            "Tracking and a direct penalty on u can yield steady-state error. "
            "Consider R=0 with Rr!=0, or reference_tracking=False."
        )

    F, G, C = create_extended_system(mpc)
    Phi, Gamma = state_predictor(F, G, mpc.Np, mpc.Nc)

    if not mpc.objectives:
        weights = create_extended_cost(mpc, mpc.weights)
        nxe, nue = G.shape
        objective = create_objective(mpc, F, Phi, Gamma, C, weights, nue, nxe)
    else:
        objective = create_variational_objective(mpc, Phi, Gamma, C)

    constraints = create_constraints(mpc, F, Phi, Gamma)

    if mpc.move_blocks:
        objective, constraints = apply_move_block(mpc, objective, constraints)

    constraints = sort_constraints(constraints)

    if mpc.settings.preprocess_mpqp:
        constraints = remove_redundant(constraints)
        constraints = remove_duplicate(constraints)

    return make_mpqp(objective, constraints)
