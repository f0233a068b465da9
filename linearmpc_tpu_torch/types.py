"""Problem-specification types for the PyTorch/CUDA linear-MPC port.

Host-side (NumPy float64) analogs of the reference spec layer
(src/types.jl), carried over unchanged from ``linearmpc_tpu/types.py``.
These are declarative containers consumed once by the condensation
compiler; the online GPU path only ever sees the compiled ``MPQP``/LDP
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .utils.linalg import matrixify

# Constraint-sense bit flags, semantically equivalent to the DAQP C API
# senses consumed by the reference (src/mpc2mpqp.jl:868-899).
ACTIVE = 1
LOWER = 2
IMMUTABLE = 4
SOFT = 8
BINARY = 16
EQUALITY = ACTIVE + IMMUTABLE  # always active, sign-free multiplier

INF_BOUND = 1e30  # bound clamp used for +-Inf rows (reference src/mpc2mpqp.jl:887-888)


@dataclass
class Constraint:
    """Stage constraint lb <= Au u_k + Ax x_k (+ Ar r_k + Ad d_k + Aup u-_k + Ap p_k) <= ub
    for k in ks (1-based time steps; k=1 is the initial state). Mirrors
    reference src/types.jl:4-18."""

    Au: np.ndarray
    Ax: np.ndarray
    Ar: np.ndarray
    Aw: np.ndarray
    Ad: np.ndarray
    Aup: np.ndarray
    Ap: np.ndarray
    ub: np.ndarray
    lb: np.ndarray
    ks: np.ndarray
    soft: bool = False
    binary: bool = False
    prio: int = 0


@dataclass
class MPCWeights:
    """Objective weights (reference src/types.jl:21-46):
    sum_k (C x_k - r_k)' Q (C x_k - r_k) + u_k' R u_k + du_k' Rr du_k
          + x_k' S u_k + (Ex p_k + ex)' x_k + (Eu p_k + eu)' u_k,
    terminal (C x_N)' Qf (C x_N) + x_N' Qfx x_N."""

    Q: np.ndarray
    R: np.ndarray
    Rr: np.ndarray
    S: np.ndarray
    Qf: np.ndarray
    Qfx: np.ndarray
    Ex: np.ndarray
    ex: np.ndarray
    Eu: np.ndarray
    eu: np.ndarray

    @staticmethod
    def default(nu: int, nx: int, nr: int) -> "MPCWeights":
        return MPCWeights(
            Q=np.eye(nr), R=np.eye(nu), Rr=np.zeros((nu, nu)),
            S=np.zeros((nx, nu)), Qf=np.zeros((nr, nr)), Qfx=np.zeros((nx, nx)),
            Ex=np.zeros((nx, 0)), ex=np.zeros(nx), Eu=np.zeros((nu, 0)), eu=np.zeros(nu),
        )

    @staticmethod
    def make(Q, R, Rr=None, *, S=None, Qf=None, Qfx=None, Ex=None, ex=None, Eu=None, eu=None) -> "MPCWeights":
        Q = matrixify(Q, None if np.ndim(Q) else 1)
        R = matrixify(R, None if np.ndim(R) else 1)
        Rr = np.zeros_like(R) if Rr is None else matrixify(Rr, R.shape[0])
        Qf = Q.copy() if Qf is None or np.size(Qf) == 0 else matrixify(Qf, Q.shape[0])
        nQ, nR = Q.shape[0], R.shape[0]
        return MPCWeights(
            Q=Q, R=R, Rr=Rr,
            S=np.zeros((0, 0)) if S is None else np.asarray(S, dtype=np.float64),
            Qf=Qf,
            Qfx=np.zeros((0, 0)) if Qfx is None else matrixify(Qfx, None),
            Ex=np.zeros((nQ, 0)) if Ex is None else np.asarray(Ex, dtype=np.float64),
            ex=np.zeros(nQ) if ex is None else np.asarray(ex, dtype=np.float64).ravel(),
            Eu=np.zeros((nR, 0)) if Eu is None else np.asarray(Eu, dtype=np.float64),
            eu=np.zeros(nR) if eu is None else np.asarray(eu, dtype=np.float64).ravel(),
        )


@dataclass
class MPCSettings:
    """Controller settings (reference src/types.jl:62-73)."""

    condensation_weights: np.ndarray = field(default_factory=lambda: np.zeros(0))
    preprocess_mpqp: bool = True
    reference_condensation: bool = False
    reference_tracking: bool = True
    reference_preview: bool = False
    disturbance_preview: bool = False
    parameter_preview: bool = False
    soft_weight: float = 1e6
    # prioritized soft constraints: "proximal" resolves levels in ONE solve
    # with geometrically separated soft weights (fast approximation);
    # "lexicographic" solves levels sequentially with frozen higher-level
    # violations (exact DAQP break_points semantics, src/mpc2mpqp.jl:859-899)
    hierarchy: str = "proximal"
    solver_opts: dict = field(default_factory=dict)
    traj2setpoint: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))


@dataclass
class MPQP:
    """Dense multi-parametric QP (reference src/types.jl:75-105):

        min  0.5 U'HU + (f + f_theta' theta)'U   [+ 0.5 theta'H_theta theta]
        s.t. bl + W theta <= [I_bounds; A] U <= bu + W theta

    The first ``n_simple = len(bu) - A.shape[0]`` rows are simple bounds on
    the leading decision variables (implicit identity rows)."""

    H: np.ndarray
    f: np.ndarray
    H_theta: np.ndarray
    f_theta: np.ndarray
    A: np.ndarray
    bu: np.ndarray
    bl: np.ndarray
    W: np.ndarray
    senses: np.ndarray
    prio: np.ndarray
    break_points: np.ndarray
    has_binaries: bool
    is_symmetric: bool

    @property
    def n_simple(self) -> int:
        return len(self.bu) - self.A.shape[0]

    @property
    def n(self) -> int:
        return self.H.shape[0]

    @property
    def m(self) -> int:
        return len(self.bu)

    @property
    def n_theta(self) -> int:
        return self.W.shape[1]

    def extended_A(self) -> np.ndarray:
        """Full constraint matrix [I_bounds(padded); A] of shape (m, n)."""
        ns = self.n_simple
        Ib = np.eye(self.n)[:ns, :]
        return np.vstack([Ib, self.A])


@dataclass
class DenseObjective:
    """Intermediate objective produced by the condensation compiler
    (reference src/mpc2mpqp.jl:1-6)."""

    H: np.ndarray
    f: np.ndarray
    f_theta: np.ndarray
    H_theta: np.ndarray


@dataclass
class DenseConstraints:
    """Intermediate constraints produced by the condensation compiler
    (reference src/mpc2mpqp.jl:8-16). Simple bounds occupy the leading
    ``len(bu) - A.shape[0]`` rows."""

    A: np.ndarray
    bu: np.ndarray
    bl: np.ndarray
    W: np.ndarray
    issoft: np.ndarray
    isbinary: np.ndarray
    prio: np.ndarray


@dataclass
class ParameterRange:
    """Box over the parameter vector theta = [x; r; d; uprev; p]
    (reference src/types.jl:184-224)."""

    xmin: np.ndarray
    xmax: np.ndarray
    rmin: np.ndarray
    rmax: np.ndarray
    dmin: np.ndarray
    dmax: np.ndarray
    umin: np.ndarray
    umax: np.ndarray
    pmin: np.ndarray
    pmax: np.ndarray

    @staticmethod
    def from_mpc(mpc) -> "ParameterRange":
        nx, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
        if nuprev > 0:
            nmin, nmax = len(mpc.umin), len(mpc.umax)
            nb = max(nmin, nmax)
            umin = np.concatenate([mpc.umin, -100 * np.ones(nb - nmin)])
            umax = np.concatenate([mpc.umax, +100 * np.ones(nb - nmax)])
        else:
            umin, umax = np.zeros(0), np.zeros(0)
        return ParameterRange(
            xmin=-100 * np.ones(nx), xmax=100 * np.ones(nx),
            rmin=-100 * np.ones(nr), rmax=100 * np.ones(nr),
            dmin=-100 * np.ones(nd), dmax=100 * np.ones(nd),
            umin=umin, umax=umax,
            pmin=-100 * np.ones(np_), pmax=100 * np.ones(np_),
        )

    def lower(self) -> np.ndarray:
        return np.concatenate([self.xmin, self.rmin, self.dmin, self.umin, self.pmin])

    def upper(self) -> np.ndarray:
        return np.concatenate([self.xmax, self.rmax, self.dmax, self.umax, self.pmax])
