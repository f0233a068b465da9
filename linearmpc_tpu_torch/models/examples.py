"""Canonical example plants and controllers (reference src/mpc_examples.jl).

Ten plants with aliases, default horizons, parameter ranges and scenarios:
inverted pendulum on a cart, DC motor, aircraft, chained integrators,
mass-spring, linearized nonlinear demo, hybrid pendulum-with-contact,
ball-and-plate, crazyflie quadrotor, and hybrid satellite.

Control/binary indices are 0-based (the reference uses 1-based); constraint
time steps ``ks`` keep the 1-based convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..mpc import MPC
from ..simulation import Scenario
from ..types import ParameterRange
from ..utils.linalg import dare, zoh
from .model import make_model, model_from_continuous, model_from_nonlinear


@dataclass
class MPCExample:
    name: str
    mpc: MPC
    range: ParameterRange
    scenarios: list[Scenario] = field(default_factory=list)


_SPECS = {
    "invpend": ("Inverted Pendulum on a Cart", ("inv_pend", "invpend", "invpendcart"), (50, 5)),
    "dcmotor": ("DC Motor Position Control", ("dc_motor", "dcmotor"), (10, 2)),
    "aircraft": ("Aircraft", ("aircraft",), (10, 2)),
    "chained": ("Chained", ("chained", "chained-firstorder"), (10, 10)),
    "mass_spring": ("Mass-Spring System", ("mass-spring", "mass", "spring"), (10, 10)),
    "nonlinear_demo": ("Linearized Nonlinear Demo", ("nonlinear", "nonlin"), (5, 2)),
    "invpend_contact": ("Colliding Inverted Pendulum on a Cart", ("invpend_contact",), (10, 10)),
    "ballplate": ("Ball and Plate", ("ball", "ballplate"), (10, 2)),
    "crazyflie": ("Quadcopter", ("quad", "quadcopter", "crazyflie"), (10, 10)),
    "satellite": ("Satellite", ("satellite",), (20, 20)),
}

_ALIASES: dict[str, str] = {}
for _id, (_, aliases, _) in _SPECS.items():
    _ALIASES[_id.replace("_", "").replace("-", "").lower()] = _id
    for a in aliases:
        _ALIASES[a.replace("_", "").replace("-", "").replace(" ", "").lower()] = _id


def mpc_example_names():
    return sorted(_SPECS.keys())


def _resolve(name: str) -> str:
    key = str(name).replace("_", "").replace("-", "").replace(" ", "").lower()
    if key not in _ALIASES:
        raise ValueError(
            f"There is currently no example `{name}`. Available: {', '.join(mpc_example_names())}."
        )
    return _ALIASES[key]


def mpc_example(name, Np=None, Nc=None, *, params=None, settings=None, **kwargs) -> MPCExample:
    eid = _resolve(name)
    dNp, dNc = _SPECS[eid][2]
    if Np is None:
        Np, Nc = dNp, dNc
    elif Nc is None:
        Nc = Np
    kw = dict(params or {})
    kw.update(kwargs)
    build = globals()[f"_build_{eid}"]
    return build(int(Np), int(Nc), settings=settings, **kw)


def _finalize(eid, mpc, rng, scenarios, settings):
    if settings is not None:
        mpc.settings = settings
        mpc.invalidate()
    return MPCExample(_SPECS[eid][0], mpc, rng, scenarios)


# ---------------------------------------------------------------------------


def _build_invpend(Np, Nc, *, settings=None, M=1.0, m=1.0, l=0.5, damp=10.0, **_):
    """(reference src/mpc_examples.jl:104-141)"""
    g = 9.81
    scale, Mm = 100.0, M + m

    def f(x, u, d):
        s, c = torch.sin(x[2]), torch.cos(x[2])
        acc = (scale * u[0] - damp * x[1] - m * l * x[3] ** 2 * s + m * g * s * c) / (M + m * s**2)
        aacc = (g * s + (scale * u[0] - damp * x[1] - m * l * x[3] ** 2 * s) * c / Mm) / (
            l - m * l * c**2 / Mm
        )
        return torch.stack([x[1], acc, x[3], aacc])

    def h(x, u, d):
        return torch.stack([x[0], x[2]])

    Ts = 0.01
    model = model_from_nonlinear(f, h, np.zeros(4), np.zeros(1), Ts=Ts)
    mpc = MPC(model, Np=Np, Nc=Nc)
    mpc.set_objective(Q=[1.2**2, 1], R=[0.0], Rr=[1.0])
    mpc.set_bounds(umin=[-2.0], umax=[2.0])

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 20.0, -20.0
    rng.rmax[:], rng.rmin[:] = 20.0, -20.0
    rng.dmax[:], rng.dmin[:] = 20.0, -20.0

    scenarios = [
        Scenario([0.0, 0.0, 0.15, 0.0], T=2.0, r=[0.0, 0.0]),
        Scenario(np.zeros(4), T=2.0, r=[1.0, 0.0]),
    ]
    return _finalize("invpend", mpc, rng, scenarios, settings)


def _build_dcmotor(Np, Nc, *, settings=None, **_):
    """(reference src/mpc_examples.jl:143-172)"""
    A = np.array([[0, 1.0, 0, 0], [-51.21, -1, 2.56, 0], [0, 0, 0, 1], [128, 0, -6.401, -10.2]])
    B = 440 * np.array([[0.0], [0], [0], [1]])
    C = np.array([[1.0, 0, 0, 0], [1280, 0, -64.01, 0]])
    Ts = 0.1
    tau = 78.5398
    C = C / np.array([[2 * np.pi], [2 * tau]])

    mpc = MPC.from_continuous(A, B, Ts, C=C, Np=Np, Nc=Nc)
    mpc.set_objective(Q=[0.1**2, 0], R=[0.0], Rr=[0.1**2])
    mpc.set_bounds(umin=[-0.5], umax=[0.5])
    mpc.add_constraint(Ax=C[1:2, :], lb=[-0.5], ub=[0.5],
                       ks=range(2, min(mpc.Nc + 2, mpc.Np) + 1), soft=True)
    mpc.settings.reference_tracking = True

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:] = [4 * np.pi, 4 * np.pi / Ts, 4 * np.pi * 20, 4 * np.pi * 20 / Ts]
    rng.xmin[:] = -rng.xmax
    rng.rmax[:] = [5, 0.5]
    rng.rmin[:] = -rng.rmax
    rng.umax[:] = [0.5023]
    rng.umin[:] = -rng.umax

    scenarios = [Scenario(np.zeros(4), T=2.0, r=[1.0, 0.0])]
    return _finalize("dcmotor", mpc, rng, scenarios, settings)


def _build_aircraft(Np, Nc, *, settings=None, **_):
    """(reference src/mpc_examples.jl:174-208)"""
    A = np.array([
        [-0.0151, -60.5651, 0, -32.174],
        [-0.0001, -1.3411, 0.9929, 0],
        [0.00018, 43.2541, -0.86939, 0],
        [0, 0, 1, 0],
    ])
    B = np.array([[-2.516, -13.136], [-0.1689, -0.2514], [-17.251, -1.5766], [0, 0]])
    C = np.array([[0, 1.0, 0, 0], [0, 0, 0, 1]])

    Ts = 0.05
    F, G = zoh(A, B, Ts)
    C = C / np.array([[1.0], [200.0]])
    Dd = np.array([[1.0, 0], [0, 200]]) / np.array([[1.0], [200.0]])

    mpc = MPC.from_discrete(F, 50 * G, C=C, Dd=Dd, Ts=Ts, Np=Np, Nc=Nc)
    mpc.set_objective(Q=np.array([10.0, 10.0]) ** 2, R=np.zeros(2), Rr=np.array([0.1, 0.1]) ** 2)
    mpc.set_bounds(umin=[-0.5, -0.5], umax=[0.5, 0.5])
    mpc.set_output_bounds(ymin=[-0.5, -0.5], ymax=[0.5, 0.5], ks=[2])
    mpc.settings.reference_tracking = True

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 20.0, -20.0
    rng.dmax[:], rng.dmin[:] = 20.0, -20.0
    rng.rmax[:] = [1, 0.05]
    rng.rmin[:] = -rng.rmax

    scenarios = [Scenario(np.zeros(4), T=2.0, r=[0.1, 0.0], d=np.zeros(2))]
    return _finalize("aircraft", mpc, rng, scenarios, settings)


def _build_chained(Np, Nc, *, settings=None, nx=1, **_):
    """(reference src/mpc_examples.jl:210-239)"""
    nx = int(nx)
    A = -np.eye(nx) + np.diag(np.ones(nx - 1), -1)
    B = np.vstack([np.ones((1, 1)), np.zeros((nx - 1, 1))])
    C = np.eye(nx)
    Ts = 1.0
    F, G = zoh(A, B, Ts)

    mpc = MPC.from_discrete(F, G, C=C, Ts=Ts, Np=Np, Nc=Nc)
    mpc.set_objective(Q=np.ones(nx), R=[0.0], Rr=[1.0])
    mpc.set_bounds(umin=[-1.0], umax=[1.0])
    mpc.set_output_bounds(ymin=-10 * np.ones(nx), ymax=10 * np.ones(nx), ks=range(2, mpc.Nc + 1))
    mpc.settings.reference_tracking = True

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 10.0, -10.0
    rng.rmax[:], rng.rmin[:] = 10.0, -10.0

    x0 = np.zeros(nx)
    x0[0] = 3.0
    scenarios = [Scenario(x0, N=15, r=np.zeros(nx))]
    return _finalize("chained", mpc, rng, scenarios, settings)


def _build_mass_spring(Np, Nc, *, settings=None, kappa=1.0, lam=0.0, nm=None, nx=None, **_):
    """(reference src/mpc_examples.jl:241-286)"""
    if nm is not None:
        nm = int(nm)
    elif nx is None:
        nm = 1
    else:
        nx = int(nx)
        nm = max(1, (nx if nx % 2 == 0 else nx - 1) // 2)
    nx = 2 * nm

    Fx = (
        np.diag(kappa * np.ones(nm - 1), 1)
        + np.diag(kappa * np.ones(nm - 1), -1)
        + np.diag(-2 * kappa * np.ones(nm))
    )
    Fv = (
        np.diag(lam * np.ones(nm - 1), 1)
        + np.diag(lam * np.ones(nm - 1), -1)
        + np.diag(-2 * lam * np.ones(nm))
    )
    A = np.block([[np.zeros((nm, nm)), np.eye(nm)], [Fx, Fv]])
    B = np.vstack([np.zeros((nm, 1)), np.ones((1, 1)), np.zeros((nm - 1, 1))])
    C = np.eye(2 * nm)
    Ts = 0.5
    F, G = zoh(A, B, Ts)

    mpc = MPC.from_discrete(F, G, C=C, Ts=Ts, Np=Np, Nc=Nc)
    mpc.set_objective(Q=100 * np.ones(nx), R=[1.0], Rr=[0.0])
    mpc.set_bounds(umin=[-0.5], umax=[0.5])
    mpc.add_constraint(Ax=np.hstack([np.eye(nm), np.zeros((nm, nm))]),
                       lb=-4 * np.ones(nm), ub=4 * np.ones(nm), ks=range(2, mpc.Nc + 1))
    mpc.settings.reference_tracking = False

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 4.0, -4.0

    x0 = np.zeros(nx)
    x0[0] = 1.0
    scenarios = [Scenario(x0, N=15)]
    return _finalize("mass_spring", mpc, rng, scenarios, settings)


def _build_nonlinear_demo(Np, Nc, *, settings=None, **_):
    """(reference src/mpc_examples.jl:288-320)"""
    F = np.array([
        [0.8187, 0, 0, 0, 0],
        [0.1474, 0.6550, -0.1637, 0.0489, 0.4878],
        [0.01637, 0.1637, 0.9825, 3.43e-3, 0.0523],
        [0, 0, 0, 0.8013, -0.1801],
        [0, 0, 0, 0.1801, 0.9813],
    ])
    G = np.array([
        [0.1813, 0, 0],
        [0.0163, 0.1637, 3.43e-3],
        [1.14e-3, 0.0175, 1.77e-4],
        [0, 0, 0.1801],
        [0, 0, 0.0186],
    ])
    C = np.array([[1.0, 0, 0, 0, 0], [0, 1, 2, 0, 0]])

    mpc = MPC.from_discrete(F, G, C=C, Ts=0.2, Np=Np, Nc=Nc)
    mpc.set_objective(Q=[1.0, 1.0], R=np.zeros(3), Rr=(1e-1 * np.ones(3)) ** 2)
    mpc.set_bounds(umin=[-3.0, 2, 2], umax=[3.0, 2, 2])
    mpc.settings.reference_tracking = True

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:] = [2, 1, 1, 1, 1]
    rng.xmin[:] = -0.5
    rng.rmax[:], rng.rmin[:] = 10.0, -10.0

    scenarios = [Scenario([0.5, 0, 0, 0, 0], N=15, r=[1.0, 0.0])]
    return _finalize("nonlinear_demo", mpc, rng, scenarios, settings)


def _build_invpend_contact(Np, Nc, *, settings=None, nwalls=2, mc=1.0, mp=1.0, l=1.0,
                           d=0.5, kappa=100.0, nu=10.0, **_):
    """Hybrid pendulum with contact walls; 4 binary contact-mode controls
    (reference src/mpc_examples.jl:322-424)."""
    nwalls = min(int(nwalls), 2)
    g = 10.0
    k, v = kappa, nu

    A = np.array([
        [0, 0, 1.0, 0],
        [0, 0, 0, 1.0],
        [0, mp * g / mc, 0, 0],
        [0, (mc + mp) * g / (mc * l), 0, 0],
    ])
    B = np.array([
        [0, 0, 0.0],
        [0, 0, 0.0],
        [1 / mc, 0, 0],
        [1 / (mc * l), -1 / (mp * l), 1 / (mp * l)],
    ])
    B = np.hstack([B, np.zeros((4, 4))])
    C = np.eye(4)
    Ts = 0.05
    F, G = zoh(A, B, Ts)

    mpc = MPC.from_discrete(F, G, C=C, Np=Np, Nc=Nc)
    Q = np.array([1.0, 1, 1, 1])
    R = np.concatenate([[1.0], 1e-4 * np.ones(6)])
    Qf, _ = dare(mpc.model.F, mpc.model.G[:, 0:1], np.diag(R[:1]), np.diag(Q))
    mpc.set_objective(Q=Q, R=R, Rr=np.zeros(7), Qf=Qf)
    # the reference writes umin = [-1.0; 0; zeros(4)] (src/mpc_examples.jl:
    # 352) -- one entry SHORT for the 7 controls, so set_bounds pads the
    # last binary's umin with -1e30. Its own hybrid tests never solve this
    # example (runtests.jl:40 only condenses it), so the slip is latent
    # there; solving with delta4 in {-1e30, 1} produces meaningless
    # 1e18-scale "contact modes". The evident intent (delta1..delta3 are
    # {0,1}) is a fourth {0,1} mode -- write the zero explicitly
    mpc.set_bounds(umin=np.concatenate([[-1.0, 0], np.zeros(5)]),
                   umax=np.concatenate([[1.0, 1e30, 1e30], np.ones(4)]))
    mpc.set_binary_controls([3, 4, 5, 6])
    mpc.settings.reference_tracking = False

    uby = np.array([d, np.pi / 10, 1, 1])
    lby = -uby
    mpc.set_output_bounds(ymin=lby, ymax=uby, ks=range(2, mpc.Nc + 1))

    d2l, d2u = -uby[0] + l * lby[1] - d, -lby[0] + l * uby[1] - d
    dd2l, dd2u = -uby[2] + l * lby[3], -lby[2] + l * uby[3]
    d3l, d3u = lby[0] - l * uby[1] - d, uby[0] - l * lby[1] - d
    dd3l, dd3u = lby[2] - l * uby[3], uby[2] - l * lby[3]

    u2l, u2u = k * d2l + v * dd2l, k * d2u + v * dd2u
    u3l, u3u = k * d3l + v * dd3l, k * d3u + v * dd3u

    Ax = np.array([
        [-1, l, 0, 0],
        [1, -l, 0, 0],
        [-k, k * l, -v, v * l],
        [k, -k * l, v, -v * l],
        [0, 0, 0, 0],
        [0, 0, 0, 0],
        [k, -k * l, v, -v * l],
        [-k, k * l, -v, v * l],
    ], dtype=np.float64)
    Au2 = np.array([
        [0, 0, 0, -d2u, 0, 0, 0],
        [0, 0, 0, -d2l, 0, 0, 0],
        [0, 0, 0, 0, 0, -u2u, 0],
        [0, 0, 0, 0, 0, -u2l, 0],
        [0, 1, 0, -u2u, 0, 0, 0],
        [0, 1, 0, 0, 0, -u2u, 0],
        [0, 1, 0, 0, 0, -u2l, 0],
        [0, -1, 0, u2u, 0, 0, 0],
    ], dtype=np.float64)
    Au3 = np.array([
        [0, 0, 0, 0, -d3u, 0, 0],
        [0, 0, 0, 0, -d3l, 0, 0],
        [0, 0, 0, 0, 0, 0, -u3u],
        [0, 0, 0, 0, 0, 0, -u3l],
        [0, 0, 1, 0, -u3u, 0, 0],
        [0, 0, 1, 0, 0, 0, -u3u],
        [0, 0, 1, 0, 0, 0, -u3l],
        [0, 0, -1, 0, u3u, 0, 0],
    ], dtype=np.float64)
    bg2 = np.array([d, -d2l - d, k * d, -k * d - u2l, 0, 0, -u2l - k * d, u2u + k * d])
    bg3 = np.array([d, -d3l - d, k * d, -k * d - u3l, 0, 0, -u3l - k * d, u3u + k * d])

    mpc.add_constraint(Au=Au2, Ax=Ax, ub=bg2, ks=range(2, mpc.Nc + 1))
    if nwalls == 2:
        mpc.add_constraint(Au=Au3, Ax=-Ax, ub=bg3, ks=range(2, mpc.Nc + 1))

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 20.0, -20.0

    scenarios = [Scenario([0.0, 0.05, 0.0, 0.0], N=20)]
    return _finalize("invpend_contact", mpc, rng, scenarios, settings)


def _build_ballplate(Np, Nc, *, settings=None, **_):
    """(reference src/mpc_examples.jl:426-449)"""
    A = np.array([[0, 1.0, 0, 0], [0, 0, 700, 0], [0, 0, 0, 1], [0, 0, 0, -34.69]])
    B = np.array([[0.0], [0], [0], [3.1119]])
    Ts = 0.03
    C = np.array([[1.0, 0, 0, 0]])

    F, G = zoh(A, B, Ts)
    mpc = MPC.from_discrete(F, G, C=C, Ts=Ts, Np=Np, Nc=Nc)
    mpc.set_bounds(umin=[-10.0], umax=[10.0])
    xbounds = np.array([30, 15, 15 * np.pi / 180, 1])
    mpc.add_constraint(Ax=np.eye(4), lb=-xbounds, ub=xbounds, soft=False)
    mpc.set_objective(Q=[100.0], R=[0.1], Rr=[0.0], Qf=[1.0])

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:] = xbounds
    rng.xmin[:] = -xbounds

    scenarios = [Scenario([10.0, 0, 0, 0], T=2.0, r=[0.0])]
    return _finalize("ballplate", mpc, rng, scenarios, settings)


def _build_crazyflie(Np, Nc, *, settings=None, mass=0.035, arm_length=0.046 / 1.414213562,
                     J=None, thrustToTorque=0.0008, kt=2.245365e-6 * 65536,
                     diagonal_inertia=True, Ts=1 / 500, **_):
    """12-state quadrotor with hover linearization, LQR terminal cost and
    prestabilizing feedback (reference src/mpc_examples.jl:451-531)."""
    if J is None:
        J = np.array([
            [1.66e-5, 0.83e-6, 0.72e-6],
            [0.83e-6, 1.66e-5, 1.8e-6],
            [0.72e-6, 1.8e-6, 2.93e-5],
        ])
    J = np.asarray(J, dtype=np.float64)
    if diagonal_inertia:
        J = np.diag(np.diag(J))
    g = 9.81
    km = kt * thrustToTorque
    f64 = torch.float64
    Jj = torch.as_tensor(J, dtype=f64)
    Jinv = torch.as_tensor(np.linalg.inv(J), dtype=f64)
    zero = torch.zeros((), dtype=f64)

    def hat(v):
        return torch.stack([
            torch.stack([zero, -v[2], v[1]]),
            torch.stack([v[2], zero, -v[0]]),
            torch.stack([-v[1], v[0], zero]),
        ])

    def Lmat(q):
        top = torch.cat([q[0:1], -q[1:4]])[None, :]
        bot = torch.hstack([q[1:4][:, None], q[0] * torch.eye(3, dtype=f64) + hat(q[1:4])])
        return torch.vstack([top, bot])

    Tq = torch.diag(torch.tensor([1.0, -1, -1, -1], dtype=f64))
    Hq = torch.vstack([torch.zeros((1, 3), dtype=f64), torch.eye(3, dtype=f64)])
    thrust = torch.vstack([torch.zeros((2, 4), dtype=f64), kt * torch.ones((1, 4), dtype=f64)])
    Cu = torch.vstack([
        (arm_length * kt) * torch.tensor([[-1.0, -1, 1, 1], [-1, 1, 1, -1]], dtype=f64),
        km * torch.tensor([[-1.0, 1, -1, 1]], dtype=f64),
    ])
    gravity = torch.tensor([0.0, 0, -g], dtype=f64)

    def cf_dynamics(x, u, d):
        q = x[3:6]
        vel = x[6:9]
        om = x[9:12]

        qe = torch.cat([(1 - q @ q)[None], q])
        Qm = Hq.T @ Tq @ Lmat(qe) @ Tq @ Lmat(qe) @ Hq

        rdot = vel
        qdot = 0.5 * (Lmat(qe) @ Hq @ om)
        vdot = gravity + (1 / mass) * (Qm @ thrust @ u)
        omdot = Jinv @ (-hat(om) @ (Jj @ om) + Cu @ u)
        return torch.cat([rdot, qdot[1:4], vdot, omdot])

    x0 = np.zeros(12)
    u0 = (mass * g / kt / 4) * np.ones(4)

    model = model_from_nonlinear(cf_dynamics, lambda x, u, d: x, x0, u0, Ts=Ts)
    mpc = MPC(model, Np=Np, Nc=Nc)
    mpc.settings.reference_tracking = False

    Q = [156.25, 156.25, 400, 2.777778, 2.777778, 1111.11111, 4, 4, 4, 4, 4, 25]
    R = 50 * np.ones(4)
    mpc.set_objective(Q=Q, R=R, Rr=np.zeros(4))
    mpc.set_bounds(umin=np.zeros(4), umax=np.ones(4))
    mpc.set_terminal_cost()
    mpc.set_prestabilizing_feedback()

    rng = ParameterRange.from_mpc(mpc)
    rng.xmax[:], rng.xmin[:] = 1.0, -1.0

    x0s = np.zeros(12)
    x0s[3] = 0.1
    x0s[4] = -0.1
    scenarios = [Scenario(x0s, T=1.5)]
    return _finalize("crazyflie", mpc, rng, scenarios, settings)


def _build_satellite(Np, Nc, *, settings=None, **_):
    """Hybrid satellite with on/off thrusters (reference src/mpc_examples.jl:533-546)."""
    A = np.array([[0.0, 1, 0], [0, 0, 0], [0, 0, 0]])
    B = np.array([[0.0, 0, 0], [2.5, 1, 1], [-10, 0, 0]])

    mpc = MPC.from_continuous(A, B, 0.1, Np=Np, Nc=Nc)
    mpc.set_objective(Q=[0.5e4, 1e-2, 1e-1], R=[10, 10, 10], Rr=np.zeros(3))
    mpc.set_bounds(umin=[-np.inf, 0, -1], umax=[np.inf, 1, 0])
    mpc.set_binary_controls([1, 2])

    rng = ParameterRange.from_mpc(mpc)
    scenarios = [Scenario(np.zeros(3), N=20, r=[0.5, 0.0, 0.0])]
    return _finalize("satellite", mpc, rng, scenarios, settings)
