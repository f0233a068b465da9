"""Batched closed-loop rollout: the GPU production path.

Port of ``linearmpc_tpu/rollout.py``. The JAX package fuses every step
into one ``lax.scan``; here the N steps are a Python loop on the engine's
device over a written-out batch of scenario lanes. Per step: measure,
Kalman correct, parameter assembly theta = [x; r; d; u_prev; p] (with
reference/disturbance/parameter preview windows, reference condensation
and offset-free observers), a warm-started solve, Kalman predict, plant
step. Warm starts carry the working set between steps, as DAQP's warm
start does (reference codegen DAQP_WARMSTART, src/codegen.jl:167-169).

A float32 engine steps through the warm step of its tier, the kernels on
CUDA and their plain versions on the CPU: ``fused_rollout_solve`` (K1 and
K2) at small m, ``fused_rollout_solve_iu`` (K3) with the carried masked
inverse R, or ``fused_rollout_solve_ciu`` (K4) with the carried slot
assignment and slot inverse, as ``linearmpc_tpu/rollout.py:207-246``
does. Its state is carried in float32 as in the JAX package
(``rollout.py:92,211``), and the float64 controls are cast to float32. A
float64 engine steps through the exact path of ``SolverEngine.solve_batch``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .condense import get_affine_parameter_base_dim
from .profiling import span


class RolloutResult(NamedTuple):
    xs: torch.Tensor      # (B, N, nx) plant states
    us: torch.Tensor      # (B, N, nu) applied controls
    ys: torch.Tensor      # (B, N, ny) outputs
    iters: torch.Tensor   # (B, N) solver iterations per step
    status: torch.Tensor  # (B, N)


def _pad_traj_time(traj, T_needed):
    """Hold-last pad a (B, T, n) trajectory along time to T_needed."""
    B, T, n = traj.shape
    if T >= T_needed:
        return traj[:, :T_needed, :]
    pad = traj[:, -1:, :].expand(B, T_needed - T, n)
    return torch.cat([traj, pad], dim=1)


def build_rollout(mpc, *, plant=None, use_observer=None):
    """Build a batched closed-loop rollout for ``mpc``.

    Returns ``rollout(x0s, rs, ds, ps=None, N=100) -> RolloutResult``:
      * ``x0s``: (B, nx) initial states
      * ``rs``:  (B, ny) constant reference per lane or (B, T, ny) trajectory
      * ``ds``:  (B, T, nd_measured) measured disturbances (or None)
      * ``ps``:  (B, np_base) constant or (B, T, np_base) trajectory (or None)

    ``plant``: optional (F, G, f_offset)-triple overriding the simulated
    plant (defaults to the controller model, like ``scenario.dynamics``).
    """
    mpc.ensure_setup()
    engine = mpc.engine
    dev, dtype = engine.device, engine.dtype
    model = mpc.model
    nx, nu, ny, nd_model = model.nx, model.nu, model.ny, model.nd
    nx_, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    Np = mpc.Np
    np_base = get_affine_parameter_base_dim(mpc)

    r_preview = mpc.settings.reference_preview and nr > 0
    r_condense = r_preview and mpc.settings.reference_condensation
    d_preview = mpc.settings.disturbance_preview and nd > 0
    p_preview = mpc.settings.parameter_preview and np_ > 0

    obs = mpc.state_observer
    has_obs = obs is not None if use_observer is None else bool(use_observer)
    offset_free = has_obs and hasattr(obs, "estimator")
    # offset-free: the simulated world (plant, measurement, ds input) sees
    # only the measured disturbance channels; the estimated channels come
    # from the augmented observer state (reference src/simulation.jl:87,
    # src/observer.jl:203-225)
    ndo = obs.nd_offsetfree if offset_free else 0
    nd_sim = obs.nd_measured if offset_free else nd_model

    c = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype)
    if plant is None:
        Fp, Gp, fp = c(model.F), c(model.G), c(model.f_offset)
    else:
        Fp, Gp, fp = (c(a) for a in plant)
    Gd = c(model.Gd[:, :nd_sim])
    C = c(obs.C) if offset_free else c(model.C)
    Dd = c(obs.Dd) if offset_free else c(model.Dd)
    h_off = c(obs.h_offset) if offset_free else c(model.h_offset)
    K = c(mpc.K)
    T2S = c(mpc.traj2setpoint) if r_condense else None

    if has_obs:
        est = obs.estimator if offset_free else obs
        oF, oG, oGd = c(est.F), c(est.G), c(est.Gd)
        oC, oDd, oh = c(est.C), c(est.Dd), c(est.h_offset)
        of = c(est.f_offset)
        oK = c(est.K)
        nxo = est.F.shape[0]
    else:
        nxo = 0

    m = engine.ldp.m

    def solve_step(theta, lam, act, side, carry):
        """(U, lam, act, side, iters, status, carry) of one warm-started
        step; ``carry`` is the large-m tiers' carried inverse."""
        if engine.path == "small":
            return (*engine.fused_rollout_solve(theta, lam, act, side), carry)
        if engine.path == "iu":
            return engine.fused_rollout_solve_iu(theta, lam, act, side, carry)
        if engine.path == "compact":
            return engine.fused_rollout_solve_ciu(theta, lam, act, side, carry)
        sol = engine.solve_batch(theta, warm=(lam, act, side))
        return sol.U, sol.lam, sol.active, sol.side, sol.iters, sol.status, carry

    def traj(a, B, T_need, width):
        if a is None or not width:
            return torch.zeros((B, T_need, width), dtype=dtype, device=dev)
        a = c(a)
        if a.dim() == 2:
            a = a[:, None, :]
        return _pad_traj_time(a, T_need)

    @torch.no_grad()
    def rollout(x0s, rs=None, ds=None, ps=None, N: int = 100):
        with span("lmpc.rollout.run"):
            return run(x0s, rs, ds, ps, N)

    def run(x0s, rs, ds, ps, N):
        x0s = c(x0s)
        B = x0s.shape[0]
        # normalize trajectories to (B, N + Np + 1, *) with hold-last padding
        T_need = N + Np + 1
        rs = traj(rs if nr else None, B, T_need, ny)
        ds = traj(ds, B, T_need, nd_sim)
        ps = traj(ps if np_ else None, B, T_need, max(np_base, 1))

        def window(tr, k0, width):
            # time-major (B, width, n) blocks; callers flatten to match vec()
            return tr[:, k0 : k0 + width, :]

        x = x0s
        xo = torch.zeros((B, nxo), dtype=dtype, device=dev)
        if has_obs:
            xo[:, :nx] = x0s
        uprev = torch.zeros((B, nu), dtype=dtype, device=dev)
        lam = torch.zeros((B, m), dtype=dtype, device=dev)
        act = torch.zeros((B, m), dtype=torch.bool, device=dev)
        side = torch.ones((B, m), dtype=torch.bool, device=dev)
        carry = (engine.iu_R0_init(B) if engine.path == "iu"
                 else engine.ciu_carry_init(B) if engine.path == "compact" else None)
        out = {k: [] for k in ("xs", "us", "ys", "iters", "status")}
        for kk in range(N):
            with span("lmpc.rollout.step"):
                with span("lmpc.rollout.theta"):
                    d_k = ds[:, kk, :]
                    y_m = x @ C.T + h_off + (d_k @ Dd.T if nd_sim else 0.0)

                    if has_obs:
                        inov = y_m - xo @ oC.T - oh - (d_k @ oDd.T if nd_sim else 0.0)
                        xo = xo + inov @ oK.T
                        xhat = xo[:, :nx]
                    else:
                        xhat = x
                    d_est = xo[:, nx : nx + ndo] if offset_free else None

                    parts = [xhat]
                    if nr:
                        if r_preview:
                            # reference window: steps k+1 .. k+Np (hold-last)
                            r_flat = window(rs, kk + 1, Np).reshape(B, -1)
                            parts.append(r_flat @ T2S.T if r_condense else r_flat)
                        else:
                            parts.append(rs[:, kk, :])
                    if nd:
                        if d_preview:
                            w = window(ds, kk, Np)
                            if ndo:
                                w = torch.cat([w, d_est[:, None, :].expand(B, Np, ndo)], dim=2)
                            parts.append(w.reshape(B, -1))
                        else:
                            parts.append(torch.cat([d_k, d_est], dim=1) if ndo else d_k)
                    if nuprev:
                        parts.append(uprev[:, :nuprev])
                    if np_:
                        if p_preview:
                            parts.append(window(ps, kk, Np).reshape(B, -1))
                        else:
                            parts.append(ps[:, kk, :])
                    theta = torch.cat(parts, dim=1)

                with span("lmpc.rollout.solve"):
                    U, lam_n, act, side, iters_n, status_n, carry = solve_step(
                        theta, lam, act, side, carry)

                with span("lmpc.rollout.plant"):
                    lam = lam_n.to(dtype)
                    u = U[:, :nu].to(dtype) - xhat @ K.T

                    if has_obs:
                        xo = xo @ oF.T + u @ oG.T + of + (d_k @ oGd.T if nd_sim else 0.0)

                    x_next = x @ Fp.T + u @ Gp.T + fp + (d_k @ Gd.T if nd_sim else 0.0)
                    for k, v in (("xs", x), ("us", u), ("ys", y_m), ("iters", iters_n),
                                 ("status", status_n)):
                        out[k].append(v)
                    x, uprev = x_next, u
        return RolloutResult(*(torch.stack(out[k], dim=1)
                               for k in ("xs", "us", "ys", "iters", "status")))

    return rollout
