"""The inverted pendulum on a cart (LinearMPC.jl ``src/mpc_examples.jl``)
at its published defaults, from ``invpend.json``.

States (p, v, phi, omega), input the scaled force, outputs p and phi.
About the upright rest point (phi = 0, u = 0) the example's dynamics

    dv/dt = (s u - d v - m l omega^2 sin phi + m g sin phi cos phi) / (M + m sin^2 phi)
    domega/dt = (g sin phi + (s u - d v - m l omega^2 sin phi) cos phi / (M + m))
                / (l - m l cos^2 phi / (M + m))

have the Jacobians written out below; both sides get their zero-order-hold
discretization, the program through ``MPC.from_discrete``.
"""

from __future__ import annotations

import numpy as np

from mpcbench.reference import Plant, zoh


def continuous(cfg):
    """(A, B, C) of the linearization at the upright rest point."""
    M, m, l, d, s, g = (cfg[k] for k in ("M", "m", "l", "damp", "scale", "g"))
    lam = l * M / (M + m)      # the angular equation's denominator at phi = 0
    A = np.array([[0.0, 1, 0, 0],
                  [0, -d / M, m * g / M, 0],
                  [0, 0, 0, 1],
                  [0, -d / ((M + m) * lam), g / lam, 0]])
    B = np.array([[0.0], [s / M], [0], [s / ((M + m) * lam)]])
    C = np.array([[1.0, 0, 0, 0], [0, 0, 1, 0]])
    return A, B, C


def plant(cfg) -> Plant:
    A, B, C = continuous(cfg)
    F, G = zoh(A, B, cfg["Ts"])
    return Plant(
        F=F, G=G, f_off=np.zeros(4), Np=cfg["Np"], Nc=cfg["Nc"], C=C,
        Q=np.diag(cfg["Q"]), R=np.diag(np.asarray(cfg["R"], dtype=float)),
        Rr=np.diag(np.asarray(cfg["Rr"], dtype=float)),
        umin=np.asarray(cfg["umin"], dtype=float), umax=np.asarray(cfg["umax"], dtype=float),
        tracking=True)


def program(L, cfg, p: Plant):
    """The port's controller of the same plant, through its public API."""
    mpc = L.MPC.from_discrete(p.F, p.G, C=p.C, Ts=cfg["Ts"], Np=cfg["Np"], Nc=cfg["Nc"])
    mpc.set_objective(Q=cfg["Q"], R=np.asarray(cfg["R"], dtype=float),
                      Rr=np.asarray(cfg["Rr"], dtype=float))
    mpc.set_bounds(umin=p.umin, umax=p.umax)
    mpc.settings.reference_tracking = True
    return mpc


def theta_box(cfg):
    box = cfg["theta_range"]
    parts = (("x", 4), ("r", 2), ("u_prev", 1))
    return (np.concatenate([np.full(k, box[name][0]) for name, k in parts]),
            np.concatenate([np.full(k, box[name][1]) for name, k in parts]))
