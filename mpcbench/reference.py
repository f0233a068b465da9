"""The plain reference: linear MPC condensed and solved in NumPy alone.

It imports NumPy and nothing else: no ``torch``, no ``jax``, nothing of
``linearmpc_tpu`` or of ``linearmpc_tpu_torch``. From a configuration's
plant (``Plant``, built by ``configs/<name>.py`` from the published
example) it works out everything the program derives itself: the LQR
terminal cost and feedback (a doubling Riccati solver), the condensed QP
(a forward recursion over the horizon, in its own variables), its optimum
(a dual active-set method on the least-distance form, written after the
plain NumPy solver the port keeps as its own test oracle) and, for binary
controls, a depth-first branch-and-bound to the proven optimum.

Semantics, as LinearMPC.jl states them (``src/mpc2mpqp.jl``):

    min  sum_{k=1}^{Np-1} |C x_k - r|_Q^2 + |C x_Np - r|_Qf^2 + x_Np' Qfx x_Np
         + sum_{k=0}^{Np-1} |u_k - uo|_R^2 + sum_{k=0}^{Np-1} |u_k - u_{k-1}|_Rr^2
                                                                (times 1/2)
         + sum_{k=0}^{Np-1} v_k' R K xt_k      (LinearMPC.jl's operating point)
    s.t. x_{k+1} = F x_k + G u_k + f_off,  u_k = v_k - K x_k,
         umin <= u_k <= umax,  u_k[b] in {umin[b], umax[b]} for binary b,

over the free moves v = (v_0, ..., v_{Nc-1}); past the control horizon
the input is held, u_k = u_{Nc-1} for Nc <= k < Np, so the bound rows are
those of the Nc free moves. u_{-1} is the previous input u_prev, and
theta = [x_0; r; u_prev]: r when the plant tracks a reference, u_prev
exactly when Rr is not zero (the port's order, ``get_parameter_dims``).
The program's decision vector is this v (its ``U``); the first control
is v_0 - K x_0. ``condense`` refuses the combinations it does not
implement: a control horizon shorter than Np, or an input-rate weight,
together with prestabilization, the LQR terminal cost, an operating
point uo or binary controls. ``dtype`` float32 runs every step in
float32: the control that the output comparison has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BIG = 1e30


# -- plant and linear algebra ---------------------------------------------------


@dataclass
class Plant:
    """A discrete linear plant with its MPC weights, as the benchmark
    hands it to both sides."""

    F: np.ndarray
    G: np.ndarray
    f_off: np.ndarray
    Np: int
    Q: np.ndarray            # (ny, ny) output weight, stages 1..Np-1 (and Np unless Qfx)
    R: np.ndarray            # (nu, nu), every stage 0..Np-1
    umin: np.ndarray
    umax: np.ndarray
    C: np.ndarray | None = None
    uo: np.ndarray | None = None
    tracking: bool = True    # r in theta (else none)
    lqr_terminal: bool = False   # Qfx = the LQR cost, terminal Q dropped
    prestabilize: bool = False   # u = v - K x with the LQR gain K
    binaries: list = field(default_factory=list)
    Nc: int | None = None    # control horizon (None: Np)
    Rr: np.ndarray | None = None   # (nu, nu) input-rate weight; u_prev in theta when not zero

    @property
    def nx(self) -> int:
        return self.F.shape[0]

    @property
    def nu(self) -> int:
        return self.G.shape[1]


def expm(M: np.ndarray) -> np.ndarray:
    """Matrix exponential by scaling and squaring of a Taylor series."""
    M = np.asarray(M, dtype=np.float64)
    norm = np.abs(M).sum(1).max()
    s = max(0, int(np.ceil(np.log2(norm / 0.5))) if norm > 0.5 else 0)
    A = M / 2.0 ** s
    E, term = np.eye(len(A)), np.eye(len(A))
    for k in range(1, 24):
        term = term @ A / k
        E = E + term
    for _ in range(s):
        E = E @ E
    return E


def zoh(A: np.ndarray, B: np.ndarray, Ts: float):
    """Zero-order-hold discretization: (F, G) with F = e^{A Ts}."""
    n, m = B.shape
    M = np.zeros((n + m, n + m))
    M[:n, :n], M[:n, n:] = A, B
    E = expm(M * Ts)
    return E[:n, :n], E[:n, n:]


def dare(F, G, Q, R, iters: int = 60) -> np.ndarray:
    """Stabilizing solution of the discrete algebraic Riccati equation by
    the structure-preserving doubling algorithm."""
    A, Gk, H = F.copy(), G @ np.linalg.solve(R, G.T), Q.copy()
    eye = np.eye(len(F))
    for _ in range(iters):
        W = np.linalg.inv(eye + Gk @ H)
        A_next = A @ W @ A
        Gk = Gk + A @ W @ Gk @ A.T
        H_next = H + A.T @ H @ W @ A
        done = np.abs(H_next - H).max() <= 1e-15 * max(1.0, np.abs(H_next).max())
        A, H = A_next, H_next
        if done:
            break
    return (H + H.T) / 2


def lqr(F, G, Q, R):
    """(P, K) of the infinite-horizon LQR: u = -K x."""
    P = dare(F, G, Q, R)
    K = np.linalg.solve(R + G.T @ P @ G, G.T @ P @ F)
    return P, K


# -- condensation -----------------------------------------------------------------


@dataclass
class QP:
    """min 0.5 v'Hv + (f0 + Fth th)'v  s.t.  lo0 + Lth th <= A v <= hi0 + Lth th,
    with binary rows ``bin_rows`` of A taking their lower or upper bound."""

    H: np.ndarray
    f0: np.ndarray
    Fth: np.ndarray
    A: np.ndarray
    lo0: np.ndarray
    hi0: np.ndarray
    Lth: np.ndarray
    bin_rows: np.ndarray
    row_stage: np.ndarray   # the stage k of each row of A
    Ux: np.ndarray      # first control u_0 = Ux @ [v; th] (nu, n + nth)
    K: np.ndarray
    nx: int             # theta = [x (nx); r (nr); u_prev (nu_prev)]
    nr: int
    nu_prev: int


def _refuse(p: Plant, Nc: int, rate: bool):
    """Raise on a plant whose QP ``condense`` does not implement."""
    if not 1 <= Nc <= p.Np:
        raise ValueError(f"control horizon Nc = {Nc} outside 1..Np = {p.Np}")
    if Nc == p.Np and not rate:
        return
    what = "a control horizon shorter than Np" if Nc < p.Np else "an input-rate weight Rr"
    for name, on in (("prestabilization", p.prestabilize), ("the LQR terminal cost", p.lqr_terminal),
                     ("an operating point uo", p.uo is not None and np.any(p.uo)),
                     ("binary controls", len(p.binaries) > 0)):
        if on:
            raise NotImplementedError(f"{what} together with {name}")


def condense(p: Plant) -> QP:
    """The condensed QP of ``p`` by a forward recursion: each state and
    control is an affine map of z = [v; theta; 1]."""
    nx, nu, N = p.nx, p.nu, p.Np
    Nc = N if p.Nc is None else int(p.Nc)
    rate = p.Rr is not None and bool(np.any(p.Rr))
    _refuse(p, Nc, rate)
    C = np.eye(nx) if p.C is None else p.C
    ny = C.shape[0]
    uo = np.zeros(nu) if p.uo is None else p.uo
    nr = ny if p.tracking else 0
    nup = nu if rate else 0
    nth = nx + nr + nup
    n = Nc * nu
    nz = n + nth + 1
    Qx = C.T @ p.Q @ C
    if p.lqr_terminal or p.prestabilize:
        P, K = lqr(p.F, p.G, Qx, p.R)
    if not p.prestabilize:
        K = np.zeros((nu, nx))

    # output error e_k = C x_k - r as a map of z
    Rsel = np.zeros((ny, nz))
    if p.tracking:
        Rsel[:, n + nx:n + nx + ny] = np.eye(ny)
    X = np.zeros((nx, nz))
    X[:, n:n + nx] = np.eye(nx)
    one = np.zeros(nz)
    one[-1] = 1.0
    # u_{k-1}, from u_{-1} = u_prev
    U_last = np.zeros((nu, nz))
    if rate:
        U_last[:, n + nx + nr:n + nth] = np.eye(nu)
    Hz = np.zeros((nz, nz))
    rows = []
    Ux = None
    # LinearMPC.jl's operating-point term (f -= (H_R + GKR + GKR') Uo in
    # src/mpc2mpqp.jl's create_objective) also carries R K xt_k, where xt
    # is the state that the constant input sequence uo alone would give
    # through the prestabilized loop from zero
    xt = np.zeros(nx)
    f_uo = np.zeros(n)
    for k in range(N):
        if k > 0:
            E = C @ X - Rsel
            Hz += E.T @ p.Q @ E
        U = -K @ X
        j = min(k, Nc - 1)     # the input is held past the control horizon
        U[:, j * nu:(j + 1) * nu] += np.eye(nu)
        if k == 0:
            Ux = U[:, :-1].copy()
        D = U - np.outer(uo, one)
        Hz += D.T @ p.R @ D
        if rate:
            dU = U - U_last
            Hz += dU.T @ p.Rr @ dU
            U_last = U
        if k < Nc:
            f_uo[k * nu:(k + 1) * nu] = p.R @ K @ xt
            rows.append(U)
        xt = (p.F - p.G @ K) @ xt + p.G @ uo
        X = p.F @ X + p.G @ U + np.outer(p.f_off, one)
    if p.lqr_terminal:
        Hz += X.T @ P @ X
    else:
        E = C @ X - Rsel
        Hz += E.T @ p.Q @ E
    Hz = (Hz + Hz.T) / 2

    # bound rows: every finite input bound of every free move
    A, lo0, hi0, Lth, bins, stage = [], [], [], [], [], []
    binset = set(int(b) for b in p.binaries)
    for k, U in enumerate(rows):
        for j in range(nu):
            lo, hi = p.umin[j], p.umax[j]
            if not (np.isfinite(lo) or np.isfinite(hi)):
                continue
            a = U[j]
            A.append(a[:n])
            Lth.append(-a[n:n + nth])
            lo0.append((lo if np.isfinite(lo) else -BIG) - a[-1])
            hi0.append((hi if np.isfinite(hi) else BIG) - a[-1])
            stage.append(k)
            if j in binset:
                bins.append(len(A) - 1)
    return QP(H=Hz[:n, :n], f0=Hz[:n, -1] + f_uo, Fth=Hz[:n, n:n + nth], A=np.array(A),
              lo0=np.array(lo0), hi0=np.array(hi0), Lth=np.array(Lth),
              bin_rows=np.array(bins, dtype=int), row_stage=np.array(stage, dtype=int),
              Ux=Ux, K=K, nx=nx, nr=nr, nu_prev=nup)


def objective(qp: QP, v: np.ndarray, th: np.ndarray) -> float:
    """0.5 v'Hv + f(th)'v in float64."""
    v = np.asarray(v, dtype=np.float64)
    f = qp.f0 + qp.Fth @ th
    return float(0.5 * v @ qp.H @ v + f @ v)


# -- the QP solver ---------------------------------------------------------------


def round_bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (to nearest, ties to even), kept
    in float32."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).reshape(x.shape)


class Solver:
    """Dual active-set method on the least-distance form of one QP. With
    H = L L' and w = L'v + L^{-1} f: min |w|^2 / 2 s.t. dl <= M w <= du,
    M = A L^{-T}, d = bound + A H^{-1} f; v = -H^{-1} (A' lam + f).

    ``dtype`` float64 is the reference; float32, or "bfloat16" (float32
    arithmetic with every stored matrix and every result rounded to
    bfloat16), is a control. ``sum_w``, ``sum_w2`` and ``iters`` add up
    the working-set sizes, their squares and the iterations of every
    solve, for the work count."""

    def __init__(self, qp: QP, dtype=np.float64):
        self.qp = qp
        self.bf16 = dtype == "bfloat16"
        self.dt = np.float32 if self.bf16 else dtype
        q = self.q
        H = qp.H.astype(np.float64)
        Lc = np.linalg.cholesky(H)
        Linv = np.linalg.inv(Lc)
        Mt = qp.A @ Linv.T
        self.G = q(Mt @ Mt.T)
        self.Hinv = q(Linv.T @ Linv)
        self.HinvAt = q(self.Hinv.astype(np.float64) @ qp.A.T)
        self.AHinv = q(qp.A @ self.Hinv.astype(np.float64))
        self.m = qp.A.shape[0]
        self.sum_w = self.sum_w2 = self.iters = 0

    def q(self, x):
        """The control's rounding of a result (float64: none)."""
        x = np.asarray(x).astype(self.dt)
        return round_bf16(x) if self.bf16 else x

    def bounds(self, th):
        qp, q = self.qp, self.q
        th = q(th)
        f = q(q(qp.f0) + q(q(qp.Fth) @ th))
        sh = q(self.AHinv @ f)
        lth = q(q(qp.Lth) @ th)
        return f, q(q(qp.lo0) + lth + sh), q(q(qp.hi0) + lth + sh)

    def solve(self, th, fix=None, warm=None, max_iter: int = 2000):
        """Solve at th with rows ``fix`` {row: True for the upper bound}
        held as equalities. ``warm`` = (work, sides) of a parent, a start
        whose wrongly signed rows the first iterations drop. Returns (v,
        work, sides, iters, status)."""
        G, m, q = self.G, self.m, self.q
        tol = {np.float64: 1e-9, np.float32: 1e-4}[self.dt] if not self.bf16 else 2e-2
        sign_tol = 1e-12 if self.dt == np.float64 else 1e-6
        f, dl, du = self.bounds(th)
        fix = fix or {}
        eq = np.zeros(m, dtype=bool)
        for i, up in fix.items():
            eq[i] = True
            if up:
                dl[i] = du[i]
            else:
                du[i] = dl[i]
        work: list[int] = []
        sides: dict[int, bool] = {}
        if warm is not None:
            for i in warm[0]:
                work.append(int(i))
                sides[int(i)] = bool(warm[1][int(i)])
        for i in fix:
            if i not in sides:
                work.append(i)
            sides[i] = True
        lam = np.zeros(m, dtype=self.dt)
        status, it = -1, 0
        while it < max_iter:
            it += 1
            W = np.asarray(work, dtype=int)
            self.sum_w += len(W)
            self.sum_w2 += len(W) ** 2
            if len(W):
                upw = np.array([sides[i] for i in W])
                d_W = np.where(upw, du[W], dl[W])
                GWW = G[np.ix_(W, W)]
                try:
                    lam_W = q(np.linalg.solve(GWW, -d_W))
                except np.linalg.LinAlgError:
                    lam_W = q(np.linalg.lstsq(GWW, -d_W, rcond=None)[0])
                wrong = ~eq[W] & ((upw & (lam_W < -sign_tol)) | (~upw & (lam_W > sign_tol)))
            else:
                lam_W = np.zeros(0, dtype=self.dt)
                wrong = np.zeros(0, dtype=bool)
            if wrong.any():
                # step towards the new multipliers up to the first sign change
                ks = np.nonzero(wrong)[0]
                old = lam[W[ks]]
                den = old - lam_W[ks]
                alpha = np.where(den != 0, old / np.where(den == 0, 1, den), 0.0)
                j = int(np.argmin(alpha))
                a = min(max(float(alpha[j]), 0.0), 1.0)
                lam[W] = q(lam[W] + a * (lam_W - lam[W]))
                drop = int(W[ks[j]])
                lam[drop] = 0.0
                work.remove(drop)
                del sides[drop]
                continue
            lam[:] = 0.0
            lam[W] = lam_W
            c = q(G @ lam)
            viol_up = -(du + c)
            viol_lo = dl + c
            viol = np.maximum(viol_up, viol_lo)
            if len(W):
                viol[W] = -np.inf
            i = int(np.argmax(viol))
            if viol[i] <= tol:
                status = 1
                break
            work.append(i)
            sides[i] = bool(viol_up[i] >= viol_lo[i])
        self.iters += it
        v = -(q(self.Hinv @ f) + q(self.HinvAt @ lam))
        return q(v).astype(np.float64), list(work), dict(sides), it, status


@dataclass
class BnBResult:
    v: np.ndarray
    J: float
    nodes: int
    status: int   # 1 proven optimal, 2 node limit, -1 none found


def branch_and_bound(solver: Solver, th, fix=None, node_limit: int = 100000) -> BnBResult:
    """Depth-first branch-and-bound over the binary rows, the nearer child
    first, to the proven optimum: a node is pruned when its relaxation
    cannot improve the incumbent by more than 1e-9 (1 + |J|). The
    incumbent is re-solved with every binary row fixed. ``fix`` {row:
    True for the upper bound} holds some binary rows from the start."""
    qp = solver.qp
    th = np.asarray(th, dtype=np.float64)
    bins = qp.bin_rows
    stack = [(dict(fix or {}), None)]
    best_J, best = np.inf, None
    nodes = 0
    while stack and nodes < node_limit:
        fix, warm = stack.pop()
        nodes += 1
        v, work, sides, _, st = solver.solve(th, fix, warm)
        if st != 1:
            continue
        J = objective(qp, v, th)
        if J >= best_J - 1e-9 * (1 + abs(best_J)):
            continue
        a = qp.A[bins] @ v
        lo = qp.lo0[bins] + qp.Lth[bins] @ th
        hi = qp.hi0[bins] + qp.Lth[bins] @ th
        span = np.maximum(hi - lo, 1e-300)
        frac = np.minimum(a - lo, hi - a) / span
        free = np.array([int(r) not in fix for r in bins])
        frac = np.where(free, frac, -1.0)
        j = int(np.argmax(frac))
        if frac[j] <= 1e-7:
            # every binary on a bound: an incumbent
            full = dict(fix)
            for r, x, l, h in zip(bins, a, lo, hi):
                full.setdefault(int(r), bool(h - x < x - l))
            v2, _, _, _, st2 = solver.solve(th, full, (work, sides))
            if st2 == 1:
                J2 = objective(qp, v2, th)
                if J2 < best_J:
                    best_J, best = J2, v2
            continue
        row = int(bins[j])
        up_first = bool(hi[j] - a[j] < a[j] - lo[j])
        far = dict(fix)
        far[row] = not up_first
        near = dict(fix)
        near[row] = up_first
        stack.append((far, (work, sides)))
        stack.append((near, (work, sides)))
    status = 1 if not stack else 2
    if best is None:
        return BnBResult(np.full(qp.H.shape[0], np.nan), np.inf, nodes, -1)
    return BnBResult(best, best_J, nodes, status)
