"""Batched closed-loop rollout: the GPU production path.

Port of ``linearmpc_tpu/rollout.py``. The JAX package fuses every step
into one ``lax.scan``; here the N steps are a Python loop on the engine's
device over a written-out batch of scenario lanes. Per step: measure,
Kalman correct, parameter assembly theta = [x; r; d; u_prev; p] (with
reference/disturbance/parameter preview windows, reference condensation
and offset-free observers), a warm-started solve, Kalman predict, plant
step. Warm starts carry the working set between steps, as DAQP's warm
start does (reference codegen DAQP_WARMSTART, src/codegen.jl:167-169).
Each step writes where its results are kept: slab [k] of time-major
outputs allocated once, and theta's parts into one buffer in place. A part
given per lane is written once; a trajectory is read at min(k, T - 1), so
nothing is padded.

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
    """Time-major buffers seen batch-major: each field is a ``transpose(0,
    1)`` view of the (N, B, ...) buffer the rollout writes step by step."""

    xs: torch.Tensor      # (B, N, nx) plant states
    us: torch.Tensor      # (B, N, nu) applied controls
    ys: torch.Tensor      # (B, N, ny) outputs
    iters: torch.Tensor   # (B, N) solver iterations per step
    status: torch.Tensor  # (B, N)


def _at(tr, k):
    """Step ``k`` of a per-lane input: (B, n) constant, or (B, T, n) held at
    its last step beyond T."""
    return tr if tr.dim() == 2 else tr[:, min(k, tr.shape[1] - 1)]


def _window(tr, k0, width):
    """Steps ``k0`` .. ``k0 + width - 1`` of a per-lane input as (B, width,
    n), held at its last step beyond T."""
    if tr.dim() == 2:
        return tr[:, None, :].expand(-1, width, -1)
    T = tr.shape[1]
    if k0 + width <= T:
        return tr[:, k0 : k0 + width]
    steps = torch.arange(k0, k0 + width, device=tr.device).clamp_(max=T - 1)
    return tr.index_select(1, steps)


def build_rollout(mpc, *, plant=None, use_observer=None):
    """Build a batched closed-loop rollout for ``mpc``.

    Returns ``rollout(x0s, rs, ds, ps=None, N=100) -> RolloutResult``:
      * ``x0s``: (B, nx) initial states
      * ``rs``:  (B, ny) constant reference per lane or (B, T, ny) trajectory
      * ``ds``:  (B, nd_measured) constant or (B, T, nd_measured) measured
        disturbances (or None)
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

    # theta = [xhat; r; d; u_prev; p]: where each part starts
    o_r = nx_
    o_d = o_r + nr
    o_u = o_d + nd
    o_p = o_u + nuprev
    n_theta = o_p + np_

    @torch.no_grad()
    def rollout(x0s, rs=None, ds=None, ps=None, N: int = 100):
        with span("lmpc.rollout.run"):
            return run(x0s, rs, ds, ps, N)

    def run(x0s, rs, ds, ps, N):
        x0s = c(x0s)
        B = x0s.shape[0]

        def lane_input(a, width):
            # (B, n) constant or (B, T, n); zeros where the caller gives none
            return c(a) if a is not None else torch.zeros((B, width), dtype=dtype, device=dev)

        rs = lane_input(rs, ny) if nr else None
        ds = lane_input(ds, nd_sim) if nd_sim else None
        ps = lane_input(ps, np_base) if np_ else None

        # each step writes its slab [k] of the outputs, and theta's parts in
        # place; xs holds one slab more, the state after the last step
        xs = torch.empty((N + 1, B, nx), dtype=dtype, device=dev)
        us = torch.empty((N, B, nu), dtype=dtype, device=dev)
        ys = torch.empty((N, B, ny), dtype=dtype, device=dev)
        meta = torch.empty((N, B, 2), dtype=torch.int32, device=dev)  # iters, status
        theta = torch.zeros((B, n_theta), dtype=dtype, device=dev)

        def put_r(k):
            if r_preview:
                # reference window: steps k+1 .. k+Np (hold-last)
                r_flat = _window(rs, k + 1, Np).reshape(B, -1)
                theta[:, o_r:o_d] = r_flat @ T2S.T if r_condense else r_flat
            else:
                theta[:, o_r:o_d] = _at(rs, k)

        def put_d(k):
            # the measured channels; the estimated ones follow each step
            if d_preview:
                theta[:, o_d:o_u].unflatten(1, (Np, nd_sim + ndo))[:, :, :nd_sim] = (
                    _window(ds, k, Np))
            else:
                theta[:, o_d:o_d + nd_sim] = _at(ds, k)

        def put_p(k):
            theta[:, o_p:] = (_window(ps, k, Np).reshape(B, -1) if p_preview
                              else _at(ps, k))

        # a part given per lane is written once, a trajectory every step
        per_step = []
        for put, tr in ((put_r, rs), (put_d, ds), (put_p, ps)):
            if tr is not None and tr.dim() == 3:
                per_step.append(put)
            elif tr is not None:
                put(0)

        x = xs[0]
        x.copy_(x0s)
        xo = torch.zeros((B, nxo), dtype=dtype, device=dev)
        if has_obs:
            xo[:, :nx] = x0s
        lam = torch.zeros((B, m), dtype=dtype, device=dev)
        act = torch.zeros((B, m), dtype=torch.bool, device=dev)
        side = torch.ones((B, m), dtype=torch.bool, device=dev)
        carry = (engine.iu_R0_init(B) if engine.path == "iu"
                 else engine.ciu_carry_init(B) if engine.path == "compact" else None)
        for kk in range(N):
            with span("lmpc.rollout.step"):
                with span("lmpc.rollout.theta"):
                    d_k = _at(ds, kk) if nd_sim else None
                    y_m = ys[kk]
                    torch.matmul(x, C.T, out=y_m)
                    y_m.add_(h_off)
                    if nd_sim:
                        y_m.add_(d_k @ Dd.T)

                    if has_obs:
                        inov = y_m - xo @ oC.T - oh
                        if nd_sim:
                            inov = inov - d_k @ oDd.T
                        xo = xo + inov @ oK.T
                        xhat = xo[:, :nx]
                    else:
                        xhat = x

                    theta[:, :nx] = xhat
                    for put in per_step:
                        put(kk)
                    if ndo:
                        d_est = xo[:, nx : nx + ndo]
                        if d_preview:
                            est = theta[:, o_d:o_u].unflatten(1, (Np, nd_sim + ndo))[:, :, nd_sim:]
                            est.copy_(d_est[:, None, :].expand(B, Np, ndo))
                        else:
                            theta[:, o_d + nd_sim:o_u] = d_est
                    if nuprev and kk:
                        theta[:, o_u:o_p] = us[kk - 1][:, :nuprev]

                with span("lmpc.rollout.solve"):
                    U, lam_n, act, side, iters_n, status_n, carry = solve_step(
                        theta, lam, act, side, carry)

                with span("lmpc.rollout.plant"):
                    lam = lam_n.to(dtype)
                    u = torch.sub(U[:, :nu].to(dtype), xhat @ K.T, out=us[kk])

                    if has_obs:
                        xo = xo @ oF.T + u @ oG.T + of
                        if nd_sim:
                            xo = xo + d_k @ oGd.T

                    x_next = xs[kk + 1]
                    torch.matmul(x, Fp.T, out=x_next)
                    x_next.add_(u @ Gp.T)
                    x_next.add_(fp)
                    if nd_sim:
                        x_next.add_(d_k @ Gd.T)
                    torch.stack((iters_n, status_n), dim=1, out=meta[kk])
                    x = x_next
        return RolloutResult(xs[:N].transpose(0, 1), us.transpose(0, 1), ys.transpose(0, 1),
                             meta[:, :, 0].transpose(0, 1), meta[:, :, 1].transpose(0, 1))

    return rollout
