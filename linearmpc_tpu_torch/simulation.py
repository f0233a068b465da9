"""Closed-loop simulation: reference-parity host loop.

Carried over unchanged from ``linearmpc_tpu/simulation.py``. Two engines
share the semantics (reference src/simulation.jl:37-116):

* ``simulate`` -- host loop, handles arbitrary Python ``true_dynamics``,
  measurement overrides, and callbacks; the parity path for tests.
* ``rollout.build_rollout`` -- the batched closed loop over thousands of
  scenario lanes with a warm-started dual active-set solve per step; the
  GPU production path.

Loop order per step k (identical in both): measure -> observer correct ->
previews -> compute control -> observer predict -> plant step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .condense import get_affine_parameter_base_dim
from .observer import OffsetFreeObserver


@dataclass
class Scenario:
    """(reference src/simulation.jl:1-35)"""

    x0: np.ndarray
    T: float = -1.0
    N: int = 1000
    r: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    d: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    p: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    callback: object = None
    dynamics: object = None
    get_measurement: object = None

    def __post_init__(self):
        self.x0 = np.asarray(self.x0, dtype=np.float64).ravel()
        for name in ("r", "d", "p"):
            v = getattr(self, name)
            if v is None:
                v = np.zeros((0, 0))
            else:
                v = np.asarray(v, dtype=np.float64)
                if v.ndim == 1:
                    v = v[:, None]  # a vector is a single-column (constant) trajectory
            setattr(self, name, v)


@dataclass
class Simulation:
    """(reference src/simulation.jl:13-27)"""

    ts: np.ndarray
    ys: np.ndarray
    us: np.ndarray
    xs: np.ndarray
    rs: np.ndarray
    ds: np.ndarray
    xhats: np.ndarray
    yms: np.ndarray
    solve_times: np.ndarray
    mpc: object
    scenario: Scenario


def get_preview(rs, k, Nc):
    """Hold-last preview window starting after step k (0-based k;
    reference src/simulation.jl:128-134)."""
    n, T = rs.shape
    idx = np.minimum(np.arange(k + 1, k + Nc + 1), T - 1)
    return rs[:, idx]


def simulate(mpc, scenario: Scenario) -> Simulation:
    """Reference-parity closed-loop rollout (src/simulation.jl:37-116)."""
    model = mpc.model
    N = scenario.N if scenario.T < 0 else int(abs(np.ceil(scenario.T / model.Ts)))
    dynamics = scenario.dynamics if scenario.dynamics is not None else model.true_dynamics
    has_observer = mpc.state_observer is not None
    obs = mpc.state_observer
    if has_observer:
        nd_sim = obs.nd_measured if isinstance(obs, OffsetFreeObserver) else model.nd
    else:
        nd_sim = model.nd

    if scenario.get_measurement is not None:
        get_measurement = scenario.get_measurement
    elif has_observer:
        C_meas, Dd_meas, h_meas = obs.C, obs.Dd, obs.h_offset
        def get_measurement(x, d):
            out = C_meas @ x + h_meas
            if np.size(d) > 0:
                out = out + Dd_meas @ d
            return out
    else:
        def get_measurement(x, d):
            out = model.C @ x + model.h_offset
            if np.size(d) > 0:
                out = out + model.Dd @ d
            return out

    x = scenario.x0.copy()
    xs = np.zeros((model.nx, N))
    ys = np.zeros((model.ny, N))
    rs = np.tile((model.C @ model.xo)[:, None], (1, N))
    ds = np.zeros((nd_sim, N))
    ps = np.zeros((get_affine_parameter_base_dim(mpc), N))
    us = np.zeros((model.nu, N))
    xhats = np.zeros((model.nx, N))
    ny_m = len(get_measurement(x, np.zeros(nd_sim)))
    yms = np.zeros((ny_m, N))
    solve_times = np.zeros(N)

    if scenario.r.size:
        Nr = min(N, scenario.r.shape[1])
        rs[:, :Nr] = scenario.r[:, :Nr]
        rs[:, Nr:] = scenario.r[:, -1:]
    r_preview = mpc.settings.reference_preview and scenario.r.size > 0

    if scenario.d.size:
        Ndd = min(N, scenario.d.shape[1])
        ds[:, :Ndd] = scenario.d[:, :Ndd]
        ds[:, Ndd:] = scenario.d[:, -1:]
    d_preview = mpc.settings.disturbance_preview and scenario.d.size > 0

    if scenario.p.size:
        Npp = min(N, scenario.p.shape[1])
        ps[:, :Npp] = scenario.p[:, :Npp]
        ps[:, Npp:] = scenario.p[:, -1:]
    p_preview = (
        mpc.settings.parameter_preview
        and get_affine_parameter_base_dim(mpc) > 0
        and scenario.p.size > 0
    )

    if has_observer:
        mpc.set_state(scenario.x0)

    for k in range(N):
        xs[:, k] = x
        yms[:, k] = get_measurement(x, ds[:, k])
        if has_observer:
            C_out = obs.C if isinstance(obs, OffsetFreeObserver) else obs.C
            Dd_out = obs.Dd if isinstance(obs, OffsetFreeObserver) else obs.Dd
            ys[:, k] = (C_out @ x + (Dd_out @ ds[:, k] if ds.shape[0] else 0))[: model.ny]
        else:
            ys[:, k] = yms[:, k][: model.ny]

        xhat = mpc.correct_state(yms[:, k], ds[:, k]) if has_observer else x
        xhats[:, k] = xhat[: model.nx]

        rk = get_preview(rs, k, mpc.Np) if r_preview else rs[:, k]
        dk = get_preview(ds, k - 1, mpc.Np) if d_preview else ds[:, k]
        if scenario.p.size:
            pk = get_preview(ps, k - 1, mpc.Np) if p_preview else ps[:, k]
        else:
            pk = None

        t0 = time.perf_counter()
        u = mpc.compute_control(xhat[: model.nx], r=rk, d=dk, p=pk)
        solve_times[k] = time.perf_counter() - t0

        if has_observer:
            mpc.predict_state(u, ds[:, k])

        x = np.asarray(dynamics(x, u, ds[:, k]), dtype=np.float64).ravel()
        if scenario.callback is not None:
            scenario.callback(x, u, ds[:, k], k)
        us[:, k] = u

    Ts = 1.0 if model.Ts < 0 else model.Ts
    return Simulation(Ts * np.arange(N), ys, us, xs, rs, ds, xhats, yms, solve_times, mpc, scenario)


def simulate_kw(mpc, *, x0=None, T=-1.0, N=1000, r=None, d=None, p=None,
                callback=None, dynamics=None, get_measurement=None) -> Simulation:
    """Keyword-style entry mirroring reference Simulation(mpc; kwargs...)."""
    x0 = np.zeros(mpc.model.nx) if x0 is None else x0
    return simulate(mpc, Scenario(x0=x0, T=T, N=N, r=r, d=d, p=p, callback=callback,
                                  dynamics=dynamics, get_measurement=get_measurement))
