"""State observers: steady-state Kalman filter and offset-free variants.

Host-side twin of the reference observer layer (src/observer.jl). The
steady-state gain comes from the dual Riccati equation; predict/correct are
tiny dense matvecs. The batched closed-loop rollout path re-implements the
same updates as batched torch (rollout.py) -- this module is the
reference-parity single-instance implementation and the offset-free
model-augmentation constructor (Pannocchia 2015 formulations, reference
src/setup.jl:342-487).
"""

from __future__ import annotations

import numpy as np

from .models.model import Labels, Model, make_model
from .utils.linalg import kalman_gain, matrixify


class KalmanFilter:
    """Steady-state Kalman filter (reference src/observer.jl:1-11, 52-69)."""

    def __init__(self, F, G, C, *, Gd=None, Dd=None, f_offset=None, h_offset=None,
                 x0=None, Q=None, R=None, K=None):
        F = np.atleast_2d(np.asarray(F, dtype=np.float64))
        G = np.asarray(G, dtype=np.float64)
        if G.ndim == 1:
            G = G[:, None]
        C = np.atleast_2d(np.asarray(C, dtype=np.float64))
        ny, nx = C.shape
        self.F, self.G, self.C = F, G, C
        self.Gd = np.zeros((nx, 0)) if Gd is None else np.atleast_2d(np.asarray(Gd, dtype=np.float64))
        self.Dd = np.zeros((ny, 0)) if Dd is None else np.atleast_2d(np.asarray(Dd, dtype=np.float64))
        self.f_offset = np.zeros(nx) if f_offset is None else np.asarray(f_offset, dtype=np.float64).ravel()
        self.h_offset = np.zeros(ny) if h_offset is None else np.asarray(h_offset, dtype=np.float64).ravel()
        self.x = np.zeros(nx) if x0 is None else np.asarray(x0, dtype=np.float64).ravel().copy()
        if K is None:
            Q = np.eye(nx) if Q is None else matrixify(Q, nx)
            R = np.eye(ny) if R is None else matrixify(R, ny)
            K = kalman_gain(F, C, Q, R)
        self.K = np.asarray(K, dtype=np.float64)

    def set_state(self, x):
        self.x[:] = np.asarray(x, dtype=np.float64).ravel()

    def predict(self, u, d=None):
        """x <- F x + G u (+ Gd d) + f_offset (reference src/observer.jl:104-108)."""
        self.x = self.F @ self.x + self.G @ np.asarray(u, dtype=np.float64).ravel() + self.f_offset
        if d is not None and np.size(d) > 0:
            self.x = self.x + self.Gd @ np.asarray(d, dtype=np.float64).ravel()
        return self.x

    def correct(self, y, d=None):
        """x <- x + K (y - C x - Dd d - h_offset) (reference src/observer.jl:114-118)."""
        inov = np.asarray(y, dtype=np.float64).ravel() - self.C @ self.x - self.h_offset
        if d is not None and np.size(d) > 0:
            inov = inov - self.Dd @ np.asarray(d, dtype=np.float64).ravel()
        self.x = self.x + self.K @ inov
        return self.x

    def estimated_disturbance(self):
        return np.zeros(0)


class OffsetFreeObserver:
    """Augmented-state KF estimating constant disturbance channels
    (reference src/observer.jl:13-47)."""

    def __init__(self, estimator: KalmanFilter, C, Dd, h_offset,
                 nx: int, nd_measured: int, nd_offsetfree: int, formulation: str):
        self.estimator = estimator
        self.C = np.atleast_2d(np.asarray(C, dtype=np.float64))
        self.Dd = np.atleast_2d(np.asarray(Dd, dtype=np.float64))
        self.h_offset = np.asarray(h_offset, dtype=np.float64).ravel()
        self.nx = nx
        self.nd_measured = nd_measured
        self.nd_offsetfree = nd_offsetfree
        self.formulation = formulation

    @property
    def x(self):
        return self.estimator.x[: self.nx]

    @property
    def d(self):
        return self.estimator.x[self.nx : self.nx + self.nd_offsetfree]

    @property
    def K(self):
        return self.estimator.K

    def estimated_disturbance(self):
        return self.d.copy()

    def _measured(self, d):
        ndm = self.nd_measured
        if d is None:
            return None if ndm == 0 else np.zeros(ndm)
        d = np.asarray(d, dtype=np.float64).ravel()
        if len(d) == ndm:
            return d
        if len(d) == ndm + self.nd_offsetfree:
            return d[:ndm]
        raise ValueError(f"Disturbance vector must have length {ndm} or {ndm + self.nd_offsetfree}")

    def set_state(self, x, d0=None):
        xaug = self.estimator.x
        x = np.asarray(x, dtype=np.float64).ravel()
        if len(x) == len(xaug):
            xaug[:] = x
        elif len(x) == self.nx:
            xaug[: self.nx] = x
            if d0 is None:
                xaug[self.nx :] = 0
            else:
                d0 = np.asarray(d0, dtype=np.float64).ravel()
                if len(d0) != self.nd_offsetfree:
                    raise ValueError(
                        f"Offset-free disturbance estimate must have length {self.nd_offsetfree}"
                    )
                xaug[self.nx :] = d0
        else:
            raise ValueError(f"Observer state must have length {self.nx} or {len(xaug)}")
        return self.x

    def predict(self, u, d=None):
        self.estimator.predict(u, self._measured(d))
        return self.x

    def correct(self, y, d=None):
        self.estimator.correct(y, self._measured(d))
        return self.x


# ---------------------------------------------------------------------------
# Offset-free observer construction (reference src/setup.jl:342-487)
# ---------------------------------------------------------------------------

_OFFSET_FREE_ALIASES = {
    "state": "state_disturbance",
    "state_disturbance": "state_disturbance",
    "velocity": "velocity",
    "output": "output_disturbance",
    "output_disturbance": "output_disturbance",
    "general": "general",
}


def normalize_offset_free_method(method: str) -> str:
    if method not in _OFFSET_FREE_ALIASES:
        raise ValueError(f"Unknown offset-free method {method}")
    return _OFFSET_FREE_ALIASES[method]


def rebuild_model(model: Model, Gd, Dd, disturbance_labels) -> Model:
    labels = Labels(model.labels.x, model.labels.u, model.labels.y, list(disturbance_labels))
    Gd = np.atleast_2d(np.asarray(Gd, dtype=np.float64))
    Dd = np.atleast_2d(np.asarray(Dd, dtype=np.float64))
    return model.copy_with(Gd=Gd, Dd=Dd, nd=Gd.shape[1], labels=labels)


def strip_offset_free_model(model: Model, nd_measured: int) -> Model:
    return rebuild_model(
        model, model.Gd[:, :nd_measured], model.Dd[:, :nd_measured], model.labels.d[:nd_measured]
    )


def append_offset_free_model(model: Model, Bd, Cd, disturbance_labels) -> Model:
    return rebuild_model(
        model,
        np.hstack([model.Gd, Bd]),
        np.hstack([model.Dd, Cd]),
        list(model.labels.d) + list(disturbance_labels),
    )


def default_offset_free_labels(method: str, nd: int):
    prefix = "yoff" if method == "output_disturbance" else "dof"
    return [f"{prefix}{i + 1}" for i in range(nd)]


def nominal_observer_gain(F, C, Q=None, R=None):
    nx, ny = F.shape[0], np.atleast_2d(C).shape[0]
    return KalmanFilter(F, np.zeros((nx, ny)), C, Q=Q, R=R).K


def validate_offset_free_model(F, C, Bd, Cd):
    nx = F.shape[0]
    nd = Bd.shape[1]
    ny = np.atleast_2d(C).shape[0]
    if Bd.shape[0] != nx:
        raise ValueError(f"Bd must have {nx} rows")
    if Cd.shape != (ny, nd):
        raise ValueError(f"Cd must have size ({ny}, {nd})")
    M = np.block([[F - np.eye(nx), Bd], [np.atleast_2d(C), Cd]])
    if np.linalg.matrix_rank(M) != nx + nd:
        raise ValueError("Offset-free disturbance model violates rank([F-I Bd; C Cd]) = nx + nd")


def build_offset_free_observer(model: Model, nd_measured: int, method: str, *,
                               Q=None, R=None, K=None, Bd=None, Cd=None,
                               Kx=None, Kd=None, x0=None, d0=None):
    """Builds the augmented-state observer for the chosen offset-free
    formulation (reference src/setup.jl:392-448)."""
    F, G, C = model.F, model.G, model.C
    method = normalize_offset_free_method(method)
    nx, ny = model.nx, model.ny

    if method in ("state_disturbance", "velocity"):
        K = nominal_observer_gain(F, C, Q=Q, R=R) if K is None else np.asarray(K, dtype=np.float64)
        if K.shape != (nx, ny):
            raise ValueError(f"K must have size ({nx}, {ny})")
        Bd = K
        Cd = np.eye(ny) - C @ K
        Kx = K
        Kd = np.eye(ny)
    elif method == "output_disturbance":
        Bd = np.zeros((nx, ny))
        Cd = np.eye(ny)
    else:
        if Bd is None:
            raise ValueError("Method 'general' requires Bd")
        if Cd is None:
            raise ValueError("Method 'general' requires Cd")

    Bd = np.atleast_2d(np.asarray(Bd, dtype=np.float64))
    Cd = np.atleast_2d(np.asarray(Cd, dtype=np.float64))
    validate_offset_free_model(F, C, Bd, Cd)
    ndo = Bd.shape[1]

    x0 = np.zeros(nx) if x0 is None else np.asarray(x0, dtype=np.float64).ravel()
    d0 = np.zeros(ndo) if d0 is None else np.asarray(d0, dtype=np.float64).ravel()
    if len(x0) != nx:
        raise ValueError(f"x0 must have length {nx}")
    if len(d0) != ndo:
        raise ValueError(f"d0 must have length {ndo}")

    Faug = np.block([[F, Bd], [np.zeros((ndo, nx)), np.eye(ndo)]])
    Gaug = np.vstack([G, np.zeros((ndo, model.nu))])
    Gdaug = np.vstack([model.Gd[:, :nd_measured], np.zeros((ndo, nd_measured))])
    Caug = np.hstack([C, Cd])
    xaug0 = np.concatenate([x0, d0])
    faug = np.concatenate([model.f_offset, np.zeros(ndo)])

    if Kx is not None or Kd is not None or method in ("state_disturbance", "velocity"):
        Kx = np.zeros((nx, ny)) if Kx is None else np.asarray(Kx, dtype=np.float64)
        Kd = np.zeros((ndo, ny)) if Kd is None else np.asarray(Kd, dtype=np.float64)
        if Kx.shape != (nx, ny):
            raise ValueError(f"Kx must have size ({nx}, {ny})")
        if Kd.shape != (ndo, ny):
            raise ValueError(f"Kd must have size ({ndo}, {ny})")
        estimator = KalmanFilter(
            Faug, Gaug, Caug, Gd=Gdaug, Dd=model.Dd[:, :nd_measured],
            f_offset=faug, h_offset=model.h_offset, x0=xaug0, K=np.vstack([Kx, Kd]),
        )
    else:
        estimator = KalmanFilter(
            Faug, Gaug, Caug, Gd=Gdaug, Dd=model.Dd[:, :nd_measured],
            f_offset=faug, h_offset=model.h_offset, Q=Q, R=R, x0=xaug0,
        )

    observer = OffsetFreeObserver(
        estimator, model.C, model.Dd[:, :nd_measured], model.h_offset,
        nx, nd_measured, ndo, method,
    )
    return observer, Bd, Cd
