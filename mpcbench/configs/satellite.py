"""The hybrid satellite (LinearMPC.jl ``src/mpc_examples.jl``) at its
published defaults, from ``satellite.json``: a continuous plant with two
on/off thrusters, zero-order-hold discretized here and handed to both
sides, the program through ``MPC.from_discrete``."""

from __future__ import annotations

import numpy as np

from mpcbench.reference import Plant, zoh


def _bounds(v, missing):
    return np.array([missing if x is None else float(x) for x in v])


def plant(cfg) -> Plant:
    F, G = zoh(np.asarray(cfg["A"], dtype=float), np.asarray(cfg["B"], dtype=float), cfg["Ts"])
    assert cfg["Np"] == cfg["Nc"]
    return Plant(
        F=F, G=G, f_off=np.zeros(3), Np=cfg["Np"], Q=np.diag(cfg["Q"]),
        R=np.diag(np.asarray(cfg["R"], dtype=float)),
        umin=_bounds(cfg["umin"], -np.inf), umax=_bounds(cfg["umax"], np.inf), tracking=True, binaries=list(cfg["binary_controls"]))


def program(L, cfg, p: Plant):
    """The port's controller of the same plant, through its public API."""
    mpc = L.MPC.from_discrete(p.F, p.G, Ts=cfg["Ts"], Np=cfg["Np"], Nc=cfg["Nc"])
    mpc.set_objective(Q=cfg["Q"], R=np.asarray(cfg["R"], dtype=float),
                      Rr=np.asarray(cfg["Rr"], dtype=float))
    mpc.set_bounds(umin=p.umin, umax=p.umax)
    mpc.set_binary_controls(cfg["binary_controls"])
    mpc.settings.solver_opts["bnb_node_limit"] = int(cfg["node_limit"])
    return mpc


def theta_box(cfg):
    (xl, xh), (rl, rh) = cfg["theta_range"]["x"], cfg["theta_range"]["r"]
    return np.r_[np.full(3, xl), np.full(3, rl)], np.r_[np.full(3, xh), np.full(3, rh)]
