"""The Crazyflie quadrotor (LinearMPC.jl ``src/mpc_examples.jl``) at its
published defaults, from ``crazyflie.json``.

The hover linearization is written out here in NumPy: states
(r, q, v, omega), 12 of them, with the quaternion's vector part q;
inputs the four normalized motor commands. At hover (q = 0, omega = 0,
each motor at m g / (4 kt)) the Jacobians of the example's dynamics are

    dr/dt = v,  dq/dt = omega / 2,  dv/dt = 2 g (q_y, -q_x, 0) + (kt / m) e_z 1'u,
    domega/dt = J^{-1} Cu u,

and the affine term is -B u_hover (gravity). Both sides get the
zero-order-hold discretization of these: the program through
``make_model``, the reference as its ``Plant``.
"""

from __future__ import annotations

import numpy as np

from mpcbench.reference import Plant, zoh


def continuous(cfg):
    """(A, B, f_c, u_hover) of the hover linearization."""
    g, mass = cfg["g"], cfg["mass"]
    kt = cfg["kt_per_pwm"] * cfg["pwm_range"]
    arm = cfg["arm"] / cfg["arm_divisor"]
    km = kt * cfg["thrust_to_torque"]
    J = np.diag(cfg["J_diagonal"])
    Cu = np.vstack([
        arm * kt * np.array([[-1.0, -1, 1, 1], [-1, 1, 1, -1]]),
        km * np.array([[-1.0, 1, -1, 1]]),
    ])
    A = np.zeros((12, 12))
    A[0:3, 6:9] = np.eye(3)
    A[3:6, 9:12] = 0.5 * np.eye(3)
    A[6, 4] = 2 * g
    A[7, 3] = -2 * g
    B = np.zeros((12, 4))
    B[8, :] = kt / mass
    B[9:12, :] = np.linalg.solve(J, Cu)
    u_hover = mass * g / kt / 4 * np.ones(4)
    return A, B, -B @ u_hover, u_hover


def plant(cfg) -> Plant:
    A, B, f_c, u_hover = continuous(cfg)
    F, Gx = zoh(A, np.hstack([B, f_c[:, None]]), cfg["Ts"])
    assert cfg["Np"] == cfg["Nc"]
    return Plant(
        F=F, G=Gx[:, :4], f_off=Gx[:, 4], Np=cfg["Np"],
        Q=np.diag(cfg["Q"]), R=np.diag(np.asarray(cfg["R"], dtype=float)),
        umin=np.asarray(cfg["umin"], dtype=float), umax=np.asarray(cfg["umax"], dtype=float),
        uo=u_hover, tracking=False, lqr_terminal=True, prestabilize=True)


def program(L, cfg, p: Plant):
    """The port's controller of the same plant, through its public API."""
    model = L.make_model(p.F, p.G, Ts=cfg["Ts"], f_offset=p.f_off, xo=np.zeros(12), uo=p.uo)
    mpc = L.MPC(model, Np=cfg["Np"], Nc=cfg["Nc"])
    mpc.settings.reference_tracking = False
    mpc.set_objective(Q=cfg["Q"], R=np.asarray(cfg["R"], dtype=float), Rr=np.asarray(cfg["Rr"], dtype=float))
    mpc.set_bounds(umin=np.asarray(cfg["umin"], dtype=float), umax=np.asarray(cfg["umax"], dtype=float))
    mpc.set_terminal_cost()
    mpc.set_prestabilizing_feedback()
    return mpc


def theta_box(cfg):
    lo, hi = cfg["theta_range"]["x"]
    return np.full(12, lo), np.full(12, hi)
