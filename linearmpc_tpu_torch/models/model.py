"""Discrete-time LTI plant models with affine offsets and disturbances.

Port of ``linearmpc_tpu/models/model.py``: nonlinear ``f``/``h`` callables
take and return torch tensors and are linearized with ``torch.func``.
Re-design of the reference model layer (src/model.jl). The model
is a plain host-side container (NumPy float64); the condensation compiler
consumes it once at setup time, so nothing here needs to be traced.

Semantics (reference src/model.jl:16-43):
    x+ = F x + G u + Gd d + f_offset
    y  = C x + Dd d + h_offset
with operating point (xo, uo), process-noise box [wmin, wmax] and optional
``true_dynamics``/``true_h`` closures used by closed-loop simulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.linalg import host_jacobian, zoh


def _as_tensor(v) -> torch.Tensor:
    """Float64 CPU tensor view of an array-like (a tensor passes through,
    so ``torch.func`` transforms see their own inputs)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray([] if v is None else v, dtype=np.float64).ravel())


def _as_matrix(x, rows=None, cols=None) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim == 0:
        x = x[None, None]
    return x


@dataclass
class Labels:
    """Display names for states/controls/outputs/disturbances
    (reference src/model.jl:1-14)."""

    x: list[str]
    u: list[str]
    y: list[str]
    d: list[str]

    @staticmethod
    def default(nx: int, nu: int, ny: int, nd: int) -> "Labels":
        return Labels(
            [f"x{i + 1}" for i in range(nx)],
            [f"u{i + 1}" for i in range(nu)],
            [f"y{i + 1}" for i in range(ny)],
            [f"d{i + 1}" for i in range(nd)],
        )


@dataclass
class Model:
    F: np.ndarray
    G: np.ndarray
    Gd: np.ndarray
    f_offset: np.ndarray
    xo: np.ndarray
    uo: np.ndarray
    wmin: np.ndarray
    wmax: np.ndarray
    C: np.ndarray
    Dd: np.ndarray
    h_offset: np.ndarray
    true_dynamics: object
    true_h: object
    nx: int
    nu: int
    ny: int
    nd: int
    Ts: float
    labels: Labels = field(default=None)

    def copy_with(self, **kw) -> "Model":
        from dataclasses import replace

        return replace(self, **kw)


def make_model(
    F,
    G,
    *,
    Ts: float = -1.0,
    C=None,
    Gd=None,
    f_offset=None,
    h_offset=None,
    xo=None,
    uo=None,
    Dd=None,
    wmin=None,
    wmax=None,
    true_dynamics=None,
    true_h=None,
    labels: Labels | None = None,
) -> Model:
    """Build a discrete-time model (reference src/model.jl:50-76).

    ``C`` defaults to identity (all states measured); disturbance channels
    ``Gd``/``Dd`` are zero-padded to a common width nd.
    """
    F = _as_matrix(F)
    G = _as_matrix(G)
    nx, nu = G.shape
    C = np.eye(nx) if C is None or np.size(C) == 0 else _as_matrix(C)
    ny = C.shape[0]
    if C.shape[1] != nx or F.shape[0] != nx:
        raise ValueError("Dimensions of ss-model incompatible")
    Gd = np.zeros((nx, 0)) if Gd is None or np.size(Gd) == 0 else _as_matrix(Gd)
    Dd = np.zeros((ny, 0)) if Dd is None or np.size(Dd) == 0 else _as_matrix(Dd)
    f_offset = np.zeros(nx) if f_offset is None or np.size(f_offset) == 0 else np.asarray(f_offset, dtype=np.float64).ravel()
    h_offset = np.zeros(ny) if h_offset is None or np.size(h_offset) == 0 else np.asarray(h_offset, dtype=np.float64).ravel()
    xo = np.zeros(nx) if xo is None or np.size(xo) == 0 else np.asarray(xo, dtype=np.float64).ravel()
    uo = np.zeros(nu) if uo is None or np.size(uo) == 0 else np.asarray(uo, dtype=np.float64).ravel()
    wmin = np.zeros(nx) if wmin is None or np.size(wmin) == 0 else np.asarray(wmin, dtype=np.float64).ravel()
    wmax = np.zeros(nx) if wmax is None or np.size(wmax) == 0 else np.asarray(wmax, dtype=np.float64).ravel()
    nd = max(Gd.shape[1], Dd.shape[1])
    Gd = np.hstack([Gd, np.zeros((nx, nd - Gd.shape[1]))])
    Dd = np.hstack([Dd, np.zeros((ny, nd - Dd.shape[1]))])

    if true_dynamics is None:
        def true_dynamics(x, u, d, F=F, G=G, Gd=Gd, f_offset=f_offset):
            x = np.asarray(x, dtype=np.float64).ravel()
            u = np.asarray(u, dtype=np.float64).ravel()
            out = F @ x + G @ u + f_offset
            if d is not None and np.size(d) > 0:
                out = out + Gd @ np.asarray(d, dtype=np.float64).ravel()
            return out

    if true_h is None:
        def true_h(x, u, d, C=C, Dd=Dd, h_offset=h_offset):
            x = np.asarray(x, dtype=np.float64).ravel()
            out = C @ x + h_offset
            if d is not None and np.size(d) > 0:
                out = out + Dd @ np.asarray(d, dtype=np.float64).ravel()
            return out

    return Model(
        F=F, G=G, Gd=Gd, f_offset=f_offset, xo=xo, uo=uo,
        wmin=wmin, wmax=wmax, C=C, Dd=Dd, h_offset=h_offset,
        true_dynamics=true_dynamics, true_h=true_h,
        nx=nx, nu=nu, ny=ny, nd=nd, Ts=float(Ts),
        labels=labels if labels is not None else Labels.default(nx, nu, ny, nd),
    )


def model_from_continuous(
    A,
    B,
    Ts: float,
    *,
    Bd=None,
    C=None,
    Dd=None,
    f_offset=None,
    h_offset=None,
    xo=None,
    uo=None,
    true_dynamics=None,
    true_h=None,
) -> Model:
    """ZOH-discretize a continuous-time model (reference src/model.jl:78-90).

    The affine offset and disturbance input are discretized jointly with B by
    embedding [B Bd f_offset] in a single block exponential. A continuous
    ``true_dynamics`` is wrapped into a forward-Euler step for simulation,
    matching the reference.
    """
    A = _as_matrix(A)
    B = _as_matrix(B)
    nx, nu = B.shape
    if A.shape[0] != nx:
        raise ValueError("Dimensions of ss-model incompatible")
    Bd = np.zeros((nx, 0)) if Bd is None or np.size(Bd) == 0 else _as_matrix(Bd)
    fo = np.zeros(nx) if f_offset is None or np.size(f_offset) == 0 else np.asarray(f_offset, dtype=np.float64).ravel()
    F, Gext = zoh(A, np.hstack([B, Bd, fo[:, None]]), Ts)
    G = Gext[:, :nu]
    Gd = Gext[:, nu : nu + Bd.shape[1]]
    f_off = Gext[:, -1]

    td = None
    if true_dynamics is not None:
        # forward-Euler wrap of the continuous dynamics, kept in torch so
        # set_operating_point can re-linearize it later
        def td(x, u, d, f=true_dynamics, Ts=Ts):
            x, u, d = _as_tensor(x), _as_tensor(u), _as_tensor(d)
            return x + Ts * f(x, u, d)

    return make_model(
        F, G, Ts=Ts, Gd=Gd, C=C, Dd=Dd, f_offset=f_off, h_offset=h_offset,
        xo=xo, uo=uo, true_dynamics=td, true_h=true_h,
    )


def linearize(f, h, x, u, d=None):
    """Exact-AD linearization of nonlinear (f, h) around (x, u, d).

    Returns (A, B, Bd, C, D, Dd, f_offset, h_offset) such that
    f(x,u,d) ~= A x + B u + Bd d + f_offset (reference src/model.jl:99-112).
    ``f``/``h`` take and return torch tensors (``torch.func``-traceable).
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    u = np.asarray(u, dtype=np.float64).ravel()
    d = np.zeros(0) if d is None else np.asarray(d, dtype=np.float64).ravel()
    nx, nu, nd = len(x), len(u), len(d)

    def fz(z):
        return f(z[:nx], z[nx : nx + nu], z[nx + nu :])

    def hz(z):
        return h(z[:nx], z[nx : nx + nu], z[nx + nu :])

    z0 = np.concatenate([x, u, d])
    Jf = host_jacobian(fz, z0)
    A, B, Bd = Jf[:, :nx], Jf[:, nx : nx + nu], Jf[:, nx + nu :]
    xt, ut, dt = _as_tensor(x), _as_tensor(u), _as_tensor(d)
    f0 = f(xt, ut, dt).numpy().astype(np.float64).ravel()
    f_offset = f0 - A @ x - B @ u - (Bd @ d if nd else 0.0)

    Jh = host_jacobian(hz, z0)
    C, D, Dd = Jh[:, :nx], Jh[:, nx : nx + nu], Jh[:, nx + nu :]
    h0 = h(xt, ut, dt).numpy().astype(np.float64).ravel()
    h_offset = h0 - C @ x - D @ u - (Dd @ d if nd else 0.0)
    return A, B, Bd, C, D, Dd, f_offset, h_offset


def model_from_nonlinear(f, h, x, u, *, Ts: float | None = None, d=None) -> Model:
    """Linearize nonlinear dynamics around an operating point and build a model.

    If ``Ts`` is given the nonlinear model is continuous-time and the
    linearization is ZOH-discretized; otherwise (Ts=None) ``f`` is already a
    discrete-time map (reference src/model.jl:114-124).
    """
    A, B, Bd, C, D, Dd, f_offset, h_offset = linearize(f, h, x, u, d)
    if np.any(D != 0):
        raise ValueError("Non-proper system (h depends directly on u)")
    if Ts is not None and Ts > 0:
        return model_from_continuous(
            A, B, Ts, Bd=Bd, C=C, Dd=Dd, f_offset=f_offset, h_offset=h_offset,
            xo=x, uo=u,
            true_dynamics=lambda xx, uu, dd: f(xx, uu, dd),
            true_h=h,
        )
    return make_model(
        A, B, Gd=Bd, C=C, Dd=Dd, Ts=-1.0, f_offset=f_offset, h_offset=h_offset,
        xo=x, uo=u,
        true_dynamics=lambda xx, uu, dd: f(_as_tensor(xx), _as_tensor(uu), _as_tensor(dd)),
        true_h=h,
    )
