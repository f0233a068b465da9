"""The MPC controller object: declarative spec + compiled solver engine.

Port of ``linearmpc_tpu/mpc.py``, the twin of the reference's ``MPC``
struct and mutator API (src/types.jl:108-182, src/setup.jl). Mutators
invalidate the compiled problem (``mpqp_issetup``); ``setup(device=,
dtype=)`` condenses the spec into an mpQP and lowers it to solver arrays on
that device: the card ("cuda") unless the caller names another. Without
CUDA, a setup that names no device raises and asks for ``device="cpu"``.
An implicit setup (the first solve after a mutator, ``build_rollout``)
reuses the device and dtype of the last explicit ``setup``.

Routing of the online solves: ``solve``/``compute_control`` are a batch of
one through ``SolverEngine.solve_batch``. On CUDA (default dtype float32)
that is the small-m tier, so a single solve also launches the K1 bulk and
K2 polish kernels, and reports status 1 or -1 only. With ``device="cpu"``
the default is the exact float64 path, which also reports -3 for an infeasible point.

Index conventions: control/binary indices are 0-based; constraint time
steps ``ks`` keep the reference's 1-based convention (k=1 is the initial
state, default ks = 2..Np).
"""

from __future__ import annotations

import warnings

import numpy as np

from . import condense as _condense
from .models.model import Model, make_model, model_from_continuous, model_from_nonlinear
from .observer import (
    KalmanFilter,
    OffsetFreeObserver,
    append_offset_free_model,
    build_offset_free_observer,
    default_offset_free_labels,
    strip_offset_free_model,
)
from .ops.engine import SolverEngine, resolve_device
from .ops.ldp import qp2ldp
from .profiling import span
from .types import Constraint, MPCSettings, MPCWeights, MPQP, ParameterRange
from .utils.formatting import form_parameter
from .utils.linalg import dare, matrixify


class MPC:
    def __init__(self, model: Model, *, Np: int = 10, Nc: int | None = None):
        self.model = model
        self.nr = 0
        self.nd = 0
        self.nuprev = 0
        self.np = 0
        self.Np = int(Np)
        self.Nc = int(Np if Nc is None else Nc)
        self.weights = MPCWeights.default(model.nu, model.nx, model.ny)
        self.umin = np.zeros(0)
        self.umax = np.zeros(0)
        self.binary_controls: list[int] = []
        self.Nc_binary = -1
        self.constraints: list[Constraint] = []
        self.settings = MPCSettings()
        self.mpQP: MPQP | None = None
        self.K = np.zeros((model.nu, model.nx))
        self.move_blocks: list[list[int]] = []
        self.mpqp_issetup = False
        self.uprev = np.zeros(model.nu)
        self.traj2setpoint = np.zeros((0, 0))
        self.state_observer = None
        self.dx0 = np.zeros(model.nx)
        self.objectives: list[tuple[MPCWeights, list[int]]] = []
        self.engine: SolverEngine | None = None
        self._setup_kw: dict = {}  # device and dtype of the last explicit setup

    # -- alternative constructors ------------------------------------------
    @staticmethod
    def from_discrete(F, G, *, Gd=None, C=None, Dd=None, f_offset=None, Ts=-1.0,
                      Np=10, Nc=None) -> "MPC":
        return MPC(make_model(F, G, Gd=Gd, C=C, Dd=Dd, f_offset=f_offset, Ts=Ts), Np=Np, Nc=Nc)

    @staticmethod
    def from_continuous(A, B, Ts: float, *, Bd=None, C=None, Dd=None, f_offset=None,
                        Np=10, Nc=None) -> "MPC":
        return MPC(model_from_continuous(A, B, Ts, Bd=Bd, C=C, Dd=Dd, f_offset=f_offset), Np=Np, Nc=Nc)

    # -- setup / compile ----------------------------------------------------
    def invalidate(self):
        self.mpqp_issetup = False

    def setup(self, *, device=None, dtype=None) -> "MPC":
        """Condense and lower the problem onto ``device``; the analog of the
        reference's ``setup!`` + DAQP workspace creation (src/setup.jl:7-29).
        ``device`` defaults to "cuda" (without CUDA this raises: pass
        ``device="cpu"``); ``dtype`` to float32 on CUDA and float64 on the
        CPU."""
        resolve_device(device)
        self._setup_kw = dict(device=device, dtype=dtype)
        self.mpqp_issetup = False
        self.mpQP = _condense.mpc2mpqp(self)
        lex = (self.settings.hierarchy == "lexicographic"
               and len(self.mpQP.break_points) > 0)
        ldp = qp2ldp(self.mpQP, soft_weight=self.settings.soft_weight,
                     priority_separation=1.0 if lex else 1e4)
        opts = dict(self.settings.solver_opts)
        self.engine = SolverEngine(
            ldp,
            device=device,
            dtype=dtype,
            iter_limit=int(opts.get("iter_limit", 1000)),
            primal_tol=float(opts.get("primal_tol", 1e-6)),
            sign_tol=float(opts.get("dual_tol", 1e-12)),
            has_binaries=self.mpQP.has_binaries,
            bnb_node_limit=int(opts.get("bnb_node_limit", 4096)),
            symmetric=self.mpQP.is_symmetric,
            lexicographic=lex,
            soft_weight=self.settings.soft_weight,
        )
        self.mpqp_issetup = True
        return self

    def ensure_setup(self) -> "MPC":
        """Set the problem up again if a mutator invalidated it, on the
        device and dtype of the last explicit ``setup`` (the card if there
        was none)."""
        if not self.mpqp_issetup:
            self.setup(**self._setup_kw)
        return self

    # -- bounds / constraints ----------------------------------------------
    def set_input_bounds(self, umin=None, umax=None):
        """umin <= u <= umax (reference src/setup.jl:36-45)."""
        umin = np.zeros(0) if umin is None else np.atleast_1d(np.asarray(umin, dtype=np.float64))
        umax = np.zeros(0) if umax is None else np.atleast_1d(np.asarray(umax, dtype=np.float64))
        nb = max(len(umin), len(umax))
        if nb == 0:
            return
        if nb != self.model.nu:
            raise ValueError(f"# of controls is {self.model.nu}, got bounds of dimension {nb}")
        self.umin = np.concatenate([umin, -1e30 * np.ones(nb - len(umin))])
        self.umax = np.concatenate([umax, +1e30 * np.ones(nb - len(umax))])
        self.invalidate()

    def add_constraint(self, *, Ax=None, Au=None, Ar=None, Aw=None, Ad=None, Aup=None, Ap=None,
                       ub=None, lb=None, ks=None, soft=False, binary=False, prio=0):
        """lb <= Ax x_k + Au u_k (+...) <= ub for k in ks (1-based steps;
        reference src/setup.jl:61-82)."""
        if Ax is None and Au is None:
            return
        lb = np.zeros(0) if lb is None else np.atleast_1d(np.asarray(lb, dtype=np.float64))
        ub = np.zeros(0) if ub is None else np.atleast_1d(np.asarray(ub, dtype=np.float64))
        m = max(len(lb), len(ub))
        if m == 0:
            return
        ub = ub if len(ub) == m else np.concatenate([ub, 1e30 * np.ones(m - len(ub))])
        lb = lb if len(lb) == m else np.concatenate([lb, -1e30 * np.ones(m - len(lb))])
        Ax = np.zeros((m, self.model.nx)) if Ax is None else np.atleast_2d(np.asarray(Ax, dtype=np.float64))
        Au = np.zeros((m, self.model.nu)) if Au is None else np.atleast_2d(np.asarray(Au, dtype=np.float64))
        empty = lambda: np.zeros((m, 0))
        self.constraints.append(Constraint(
            Au=Au, Ax=Ax,
            Ar=empty() if Ar is None else np.atleast_2d(np.asarray(Ar, dtype=np.float64)),
            Aw=empty() if Aw is None else np.atleast_2d(np.asarray(Aw, dtype=np.float64)),
            Ad=empty() if Ad is None else np.atleast_2d(np.asarray(Ad, dtype=np.float64)),
            Aup=empty() if Aup is None else np.atleast_2d(np.asarray(Aup, dtype=np.float64)),
            Ap=empty() if Ap is None else np.atleast_2d(np.asarray(Ap, dtype=np.float64)),
            ub=ub, lb=lb,
            ks=np.asarray(list(range(2, self.Np + 1)) if ks is None else list(ks), dtype=int),
            soft=bool(soft), binary=bool(binary), prio=int(prio),
        ))
        self.invalidate()

    def set_output_bounds(self, ymin=None, ymax=None, *, ks=None, soft=True, binary=False, prio=0):
        """lb <= C x <= ub for k in ks (reference src/setup.jl:94-98)."""
        lb = None if ymin is None else np.atleast_1d(np.asarray(ymin, dtype=np.float64)) - self.model.h_offset
        ub = None if ymax is None else np.atleast_1d(np.asarray(ymax, dtype=np.float64)) - self.model.h_offset
        self.add_constraint(Ax=self.model.C, Ad=self.model.Dd, lb=lb, ub=ub,
                            ks=ks, soft=soft, binary=binary, prio=prio)

    def set_bounds(self, *, umin=None, umax=None, ymin=None, ymax=None):
        if umin is not None or umax is not None:
            self.set_input_bounds(umin, umax)
        if ymin is not None or ymax is not None:
            self.set_output_bounds(ymin, ymax)

    # -- objective ----------------------------------------------------------
    def set_objective(self, *, Q=None, R=None, Rr=None, S=None, Qf=None, Qfx=None,
                      Ex=None, ex=None, Eu=None, eu=None, uids=None):
        """Set objective weights; with ``uids`` adds a per-player objective for
        game-theoretic MPC (reference src/setup.jl:117-152)."""
        if uids is not None:
            return self._add_player_objective(list(uids), Q=Q, R=R, Rr=Rr, S=S, Qf=Qf, Qfx=Qfx,
                                              Ex=Ex, ex=ex, Eu=Eu, eu=eu)
        w = self.weights
        ny, nu, nx = self.model.ny, self.model.nu, self.model.nx
        self.weights = MPCWeights(
            Q=w.Q.copy() if Q is None else matrixify(Q, ny),
            R=w.R.copy() if R is None else matrixify(R, nu),
            Rr=w.Rr.copy() if Rr is None else matrixify(Rr, nu),
            S=w.S.copy() if S is None else np.asarray(S, dtype=np.float64),
            Qf=w.Qf.copy() if Qf is None else matrixify(Qf, ny),
            Qfx=w.Qfx.copy() if Qfx is None else matrixify(Qfx, nx),
            Ex=w.Ex.copy() if Ex is None else np.asarray(Ex, dtype=np.float64),
            ex=w.ex.copy() if ex is None else np.asarray(ex, dtype=np.float64).ravel(),
            Eu=w.Eu.copy() if Eu is None else np.asarray(Eu, dtype=np.float64),
            eu=w.eu.copy() if eu is None else np.asarray(eu, dtype=np.float64).ravel(),
        )
        self.invalidate()

    def _add_player_objective(self, uids, *, Q=None, R=None, Rr=None, S=None, Qf=None, Qfx=None,
                              Ex=None, ex=None, Eu=None, eu=None):
        nu, ny, nx = len(uids), self.model.ny, self.model.nx
        Q = np.zeros((ny, ny)) if Q is None else matrixify(Q, ny)
        R = np.zeros((nu, nu)) if R is None else matrixify(R, nu)
        Rr = np.zeros((nu, nu)) if Rr is None else matrixify(Rr, nu)
        S = np.zeros((nx, nu)) if S is None else np.asarray(S, dtype=np.float64)
        Qf = Q.copy() if Qf is None else matrixify(Qf, ny)
        Qfx = np.zeros((nx, nx)) if Qfx is None else matrixify(Qfx, nx)
        Ex = np.zeros((nx, 0)) if Ex is None else np.asarray(Ex, dtype=np.float64)
        ex = np.zeros(nx) if ex is None else np.asarray(ex, dtype=np.float64).ravel()
        Eu = np.zeros((nu, 0)) if Eu is None else np.asarray(Eu, dtype=np.float64)
        eu = np.zeros(nu) if eu is None else np.asarray(eu, dtype=np.float64).ravel()
        self.weights.Rr[np.ix_(uids, uids)] = Rr  # so nuprev bookkeeping sees du penalties
        self.objectives.append((MPCWeights(Q, R, Rr, S, Qf, Qfx, Ex, ex, Eu, eu), uids))
        self.invalidate()

    def empty_objectives(self):
        self.objectives.clear()
        self.invalidate()

    def set_terminal_cost(self):
        """Qfx <- infinite-horizon LQR cost (reference src/setup.jl:171-179)."""
        if self.settings.reference_tracking:
            warnings.warn("LQR cost not valid for reference tracking problems; use set_objective(Qf=...)")
            return False
        P, _ = dare(self.model.F, self.model.G, self.weights.R,
                    self.model.C.T @ self.weights.Q @ self.model.C)
        self.weights.Qfx = P
        self.invalidate()
        return True

    def set_prestabilizing_feedback(self, K=None):
        """K from LQR if not given (reference src/setup.jl:186-199)."""
        if K is None:
            _, K = dare(self.model.F, self.model.G, self.weights.R + self.weights.Rr,
                        self.model.C.T @ self.weights.Q @ self.model.C)
        self.K = np.asarray(K, dtype=np.float64)
        self.invalidate()

    # -- horizon / blocking / binaries --------------------------------------
    def set_horizon(self, Np: int, Nc: int | None = None, Nc_binary: int | None = None):
        self.Np = int(Np)
        self.Nc = int(Np if Nc is None else Nc)
        if Nc_binary is not None:
            self.Nc_binary = int(Nc_binary)
        self.invalidate()

    def move_block(self, block):
        """Hold controls constant over blocks (reference src/setup.jl:209-248).
        ``block`` may be None (clear), an int, a vector, or per-input vectors."""
        if block is None or (isinstance(block, (list, tuple, np.ndarray)) and len(block) == 0):
            self.move_blocks = []
            self.Nc = self.Np
            self.invalidate()
            return
        if not isinstance(block, (list, tuple, np.ndarray)):
            b = int(block)
            if b <= 0:
                return self.move_block(None)
            return self.move_block([b] * (self.Np // b + 1))
        block = list(block)
        if not isinstance(block[0], (list, tuple, np.ndarray)):
            return self.move_block([list(block) for _ in range(self.model.nu)])
        if len(block) != self.model.nu:
            raise ValueError("Need to have blocks for every control input")
        formatted = [format_move_block(list(mb), self.Np) for mb in block]
        if any(len(mb) == 0 for mb in formatted):
            raise ValueError("One block is empty")
        self.move_blocks = formatted
        self.Nc = max(sum(mb[:-1]) for mb in formatted) + 1
        self.invalidate()

    def set_binary_controls(self, bin_ids, Nc_binary: int = -1):
        """0-based control indices forced to their bounds
        (reference src/setup.jl:277-281, which uses 1-based ids)."""
        self.binary_controls = [int(i) for i in bin_ids]
        self.Nc_binary = int(Nc_binary)
        self.invalidate()

    # -- robustness ----------------------------------------------------------
    def set_disturbance(self, wmin, wmax):
        self.model.wmin[:] = np.asarray(wmin, dtype=np.float64).ravel()
        self.model.wmax[:] = np.asarray(wmax, dtype=np.float64).ravel()
        self.invalidate()

    def set_x0_uncertainty(self, x0_uncertainty):
        self.dx0[:] = np.asarray(x0_uncertainty, dtype=np.float64).ravel()
        self.invalidate()

    # -- settings ------------------------------------------------------------
    def update_settings(self, **kwargs):
        """(reference src/setup.jl:300-321)"""
        for key, val in kwargs.items():
            if hasattr(self.settings, key):
                setattr(self.settings, key, val)
                self.invalidate()
            else:
                warnings.warn(f'The setting "{key}" does not exist')

    # -- observers ------------------------------------------------------------
    def set_state_observer(self, *, F=None, G=None, Gd=None, C=None, Dd=None,
                           f_offset=None, h_offset=None, Q=None, R=None, x0=None):
        """(reference src/setup.jl:328-340)"""
        m = self.model
        self.state_observer = KalmanFilter(
            m.F if F is None else F, m.G if G is None else G, m.C if C is None else C,
            Gd=m.Gd if Gd is None else Gd, Dd=m.Dd if Dd is None else Dd,
            f_offset=m.f_offset if f_offset is None else f_offset,
            h_offset=m.h_offset if h_offset is None else h_offset,
            Q=Q, R=R, x0=x0,
        )
        return self.state_observer

    def set_offset_free_observer(self, *, method="state_disturbance", Q=None, R=None, K=None,
                                 Bd=None, Cd=None, Kx=None, Kd=None, x0=None, d0=None,
                                 disturbance_labels=None):
        """(reference src/setup.jl:466-487)"""
        nd_measured = (
            self.state_observer.nd_measured
            if isinstance(self.state_observer, OffsetFreeObserver)
            else self.model.nd
        )
        self.model = strip_offset_free_model(self.model, nd_measured)
        observer, Bd, Cd = build_offset_free_observer(
            self.model, nd_measured, method, Q=Q, R=R, K=K, Bd=Bd, Cd=Cd,
            Kx=Kx, Kd=Kd, x0=x0, d0=d0,
        )
        labels = (
            default_offset_free_labels(observer.formulation, Bd.shape[1])
            if disturbance_labels is None
            else list(disturbance_labels)
        )
        if len(labels) != Bd.shape[1]:
            raise ValueError(f"Need {Bd.shape[1]} disturbance labels")
        self.model = append_offset_free_model(self.model, Bd, Cd, labels)
        self.state_observer = observer
        self.invalidate()
        return observer

    # observer passthroughs (reference src/observer.jl:227-265)
    def predict_state(self, u, d=None):
        return self.state_observer.predict(u, d)

    def correct_state(self, y, d=None):
        return self.state_observer.correct(y, d)

    def set_state(self, x):
        return self.state_observer.set_state(x)

    def get_state(self):
        return self.state_observer.x

    def update_state(self, u=None, y=None):
        if u is not None:
            self.state_observer.predict(u)
        if y is not None:
            self.state_observer.correct(y)
        return self.state_observer.x

    # -- operating point / offsets -------------------------------------------
    def set_operating_point(self, *, xo=None, uo=None):
        """Re-linearize the stored nonlinear dynamics at a new operating point
        (reference src/setup.jl:493-502)."""
        if xo is not None:
            self.model.xo[:] = np.asarray(xo, dtype=np.float64).ravel()
        if uo is not None:
            self.model.uo[:] = np.asarray(uo, dtype=np.float64).ravel()
        if xo is not None or uo is not None:
            Ts = self.model.Ts
            self.model = model_from_nonlinear(
                self.model.true_dynamics, self.model.true_h,
                self.model.xo, self.model.uo, Ts=None,
            )
            self.model = self.model.copy_with(Ts=Ts)
            self.invalidate()

    def set_offset(self, *, xo=None, uo=None, doff=None, fo=None, ho=None):
        """(reference src/setup.jl:516-531)"""
        m = self.model
        xo = np.zeros(m.nx) if xo is None else np.asarray(xo, dtype=np.float64).ravel()
        uo = np.zeros(m.nu) if uo is None else np.asarray(uo, dtype=np.float64).ravel()
        fo = np.zeros(m.nx) if fo is None else np.asarray(fo, dtype=np.float64).ravel()
        ho = np.zeros(m.ny) if ho is None else np.asarray(ho, dtype=np.float64).ravel()
        doff = np.zeros(m.nd) if doff is None else np.asarray(doff, dtype=np.float64).ravel()
        m.xo[:] = xo
        m.uo[:] = uo
        self.uprev[:] = uo
        m.f_offset[:] = fo - m.F @ xo - m.G @ uo - m.Gd @ doff
        m.h_offset[:] = ho - m.C @ xo - m.Dd @ doff
        self.invalidate()

    def set_labels(self, *, x=None, u=None, y=None, d=None):
        if x is not None:
            self.model.labels.x = list(x)
        if u is not None:
            self.model.labels.u = list(u)
        if y is not None:
            self.model.labels.y = list(y)
        if d is not None:
            self.model.labels.d = list(d)

    # -- parameters / online solve --------------------------------------------
    def get_parameter_dims(self):
        return _condense.get_parameter_dims(self)

    def get_parameter_names(self):
        return _condense.get_parameter_names(self)

    def parameter_range(self) -> ParameterRange:
        return ParameterRange.from_mpc(self)

    def form_parameter(self, x, r=None, d=None, uprev=None, p=None):
        return form_parameter(self, x, r, d, uprev, p)

    def solve(self, theta):
        """Solve the QP at parameter theta (reference src/utils.jl:268-283).
        Returns (U, fval, exitflag, info)."""
        self.ensure_setup()
        if not self.mpqp_issetup:
            raise RuntimeError("Could not setup optimization problem")
        return self.engine.solve(theta)

    def compute_control(self, x, *, r=None, d=None, uprev=None, p=None, check=True):
        """Optimal first control action (reference src/utils.jl:43-51)."""
        with span("lmpc.mpc.control"):
            U, theta = self._control(x, r, d, uprev, p, check)
            self.uprev = U[: self.model.nu] - self.K @ theta[: self.model.nx]
            return self.uprev.copy()

    def compute_control_trajectory(self, x, *, r=None, d=None, uprev=None, p=None, check=True):
        """Whole decision vector U (reference src/utils.jl:62-70)."""
        with span("lmpc.mpc.control"):
            U, theta = self._control(x, r, d, uprev, p, check)
            self.uprev = U[: self.model.nu] - self.K @ theta[: self.model.nx]
            return U

    def _control(self, x, r, d, uprev, p, check):
        """(U, theta) of one solve at the parameter the arguments form."""
        with span("lmpc.mpc.parameter"):
            theta = self.form_parameter(x, r, d, uprev, p)
        U, fval, exitflag, info = self.solve(theta)
        if check:
            assert exitflag >= 1, f"solver failed with exitflag {exitflag}"
        return U, theta

    def evaluate_cost(self, xs, us, rs=None, *, Q=None, R=None, Rr=None, S=None):
        """0.5 sum x'Qx + u'Ru + du'Rr du + x'Su (reference src/utils.jl:397-411)."""
        Q = self.weights.Q if Q is None else matrixify(Q, self.model.ny)
        R = self.weights.R if R is None else matrixify(R, self.model.nu)
        Rr = self.weights.Rr if Rr is None else matrixify(Rr, self.model.nu)
        S = self.weights.S if S is None else np.asarray(S, dtype=np.float64)
        nu, N = us.shape
        rs = np.zeros((self.model.ny, N)) if rs is None or np.size(rs) == 0 else rs
        dus = np.diff(np.hstack([np.zeros((nu, 1)), us]), axis=1)
        cost = 0.0
        for i in range(N):
            err = self.model.C @ xs[:, i] - rs[:, i]
            cost += err @ Q @ err
            cost += us[:, i] @ R @ us[:, i]
            cost += dus[:, i] @ Rr @ dus[:, i]
            if S.size:
                cost += xs[:, i] @ S @ us[:, i]
        return 0.5 * cost


def format_move_block(block: list[int], Np: int) -> list[int]:
    """Pad or clip a block vector to sum to Np (reference src/setup.jl:235-248)."""
    block = [int(b) for b in block]
    if not block:
        return []
    total = sum(block)
    if total < Np:
        block[-1] += Np - total
    elif total > Np:
        tot, i = 0, 0
        while True:
            tot += block[i]
            if tot >= Np:
                break
            i += 1
        block = block[: i + 1]
        block[-1] += Np - tot
    return block


def constraint_violation(c: Constraint, x, u):
    """Max violation of a stage constraint (reference src/utils.jl:417-425)."""
    x = np.asarray(x, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    if x.ndim == 2:
        return np.array([constraint_violation(c, x[:, i], u[:, i]) for i in range(x.shape[1])])
    v = c.Ax @ x + c.Au @ u
    return float(np.max(np.concatenate([c.lb - v, v - c.ub, [0.0]])))
