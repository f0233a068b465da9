"""Checkpointing: persist compiled problems for instant reload.

Port of ``linearmpc_tpu/checkpoint.py``. The files have the JAX
package's ``.npz`` layout, so a checkpoint written by either package
loads in the other. ``load_problem`` and ``load_explicit`` put what they
load on ``device`` (None: the card, as every entry point).

The reference has no checkpointing; its persisted artifacts are generated
C and explicit solutions (SURVEY.md section 5). Here the condensed mpQP +
lowered LDP arrays serialize to a single .npz, so a serving process can
reload a compiled problem without re-running condensation, and explicit
controllers persist their full region tables.
"""

from __future__ import annotations

import json

import numpy as np

from .explicit import CriticalRegion, ExplicitMPC
from .ops.engine import SolverEngine, resolve_device
from .ops.ldp import LDPData
from .types import MPQP


def save_problem(mpc, path: str) -> None:
    """Save the condensed mpQP + LDP arrays + runtime metadata."""
    mpc.ensure_setup()
    qp = mpc.mpQP
    ldp = mpc.engine.ldp
    nx, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    meta = dict(
        nx=nx, nr=nr, nd=nd, nuprev=nuprev, np=np_,
        nu=mpc.model.nu, Np=mpc.Np, Nc=mpc.Nc,
        has_binaries=qp.has_binaries, is_symmetric=qp.is_symmetric,
        soft_weight=mpc.settings.soft_weight,
    )
    arrays = {f"qp_{k}": getattr(qp, k) for k in
              ("H", "f", "H_theta", "f_theta", "A", "bu", "bl", "W",
               "senses", "prio", "break_points")}
    arrays.update({f"ldp_{k}": np.asarray(getattr(ldp, k)) for k in
                   ("G", "Dth", "du", "dl", "HinvET", "Uth_off", "u_off",
                    "H", "f", "f_theta", "is_eq", "is_immutable", "is_soft",
                    "is_binary", "up_finite", "lo_finite", "rho_soft", "scaling")})
    arrays["K"] = mpc.K
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_problem(path: str, *, device=None):
    """Reload (mpqp, ldp, meta, K) and build a fresh SolverEngine on
    ``device`` (None: the card; its default dtype)."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    qp = MPQP(
        H=z["qp_H"], f=z["qp_f"], H_theta=z["qp_H_theta"], f_theta=z["qp_f_theta"],
        A=z["qp_A"], bu=z["qp_bu"], bl=z["qp_bl"], W=z["qp_W"],
        senses=z["qp_senses"], prio=z["qp_prio"], break_points=z["qp_break_points"],
        has_binaries=bool(meta["has_binaries"]), is_symmetric=bool(meta["is_symmetric"]),
    )
    ldp = LDPData(
        G=z["ldp_G"], Dth=z["ldp_Dth"], du=z["ldp_du"], dl=z["ldp_dl"],
        HinvET=z["ldp_HinvET"], Uth_off=z["ldp_Uth_off"], u_off=z["ldp_u_off"],
        H=z["ldp_H"], f=z["ldp_f"], f_theta=z["ldp_f_theta"],
        is_eq=z["ldp_is_eq"], is_immutable=z["ldp_is_immutable"],
        is_soft=z["ldp_is_soft"], is_binary=z["ldp_is_binary"],
        up_finite=z["ldp_up_finite"], lo_finite=z["ldp_lo_finite"],
        rho_soft=z["ldp_rho_soft"], scaling=z["ldp_scaling"],
    )
    engine = SolverEngine(
        ldp, device=device, has_binaries=qp.has_binaries, symmetric=qp.is_symmetric,
    )
    return qp, ldp, meta, z["K"], engine


def save_explicit(empc, path: str) -> None:
    """Persist an explicit controller's region table."""
    arrays = {
        "nth": np.asarray(empc.nth), "nu": np.asarray(empc.nu),
        "lb": empc.lb, "ub": empc.ub,
        "n_regions": np.asarray(len(empc.regions)),
    }
    for i, cr in enumerate(empc.regions):
        arrays[f"r{i}_Ath"] = cr.Ath
        arrays[f"r{i}_bth"] = cr.bth
        arrays[f"r{i}_F"] = cr.F
        arrays[f"r{i}_g"] = cr.g
        arrays[f"r{i}_as"] = np.asarray(cr.active_set, dtype=np.int64)
    np.savez_compressed(path, **arrays)


def load_explicit(path: str, *, device=None):
    """Reload an explicit controller (evaluation only; no source MPC) that
    evaluates on ``device`` (None: the card)."""
    z = np.load(path)
    n = int(z["n_regions"])
    regions = []
    for i in range(n):
        regions.append(CriticalRegion(
            active_set=tuple(z[f"r{i}_as"].tolist()),
            Ath=z[f"r{i}_Ath"], bth=z[f"r{i}_bth"],
            F=z[f"r{i}_F"], g=z[f"r{i}_g"],
            Flam=None, glam=None,
        ))
    return ExplicitMPC(
        regions=regions, qp=None, nth=int(z["nth"]), nu=int(z["nu"]),
        lb=z["lb"], ub=z["ub"], mpc=None, device=resolve_device(device),
    )
