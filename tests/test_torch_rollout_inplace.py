"""The rollout's in-place writes against the loop they replaced, on the
CPU: time-major outputs filled step by step, theta assembled in one buffer
and per-lane inputs read without padding give, bit for bit, what the old
loop gave, which appended each step's outputs to lists, stacked them at the
end, concatenated theta every step and padded every input to N + Np + 1
steps. The old loop's body is kept here as the reference, over the same
engine: the small-m tier (invpend), the IU tier (crazyflie) and the exact
float64 path with preview windows, reference condensation and observers.
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch.condense import get_affine_parameter_base_dim
from linearmpc_tpu_torch.mpc import MPC as TMPC
from linearmpc_tpu_torch.rollout import build_rollout


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked_rollout(mpc, x0s, rs, ds, ps, N):
    """The old rollout loop: lists of steps stacked at the end, theta by
    ``torch.cat`` every step, inputs hold-last padded to N + Np + 1."""
    engine = mpc.engine
    dev, dtype = engine.device, engine.dtype
    model = mpc.model
    nx, nu, ny, nd_model = model.nx, model.nu, model.ny, model.nd
    _nx, nr, nd, nuprev, np_ = mpc.get_parameter_dims()
    Np = mpc.Np
    np_base = get_affine_parameter_base_dim(mpc)
    r_preview = mpc.settings.reference_preview and nr > 0
    r_condense = r_preview and mpc.settings.reference_condensation
    d_preview = mpc.settings.disturbance_preview and nd > 0
    p_preview = mpc.settings.parameter_preview and np_ > 0
    obs = mpc.state_observer
    has_obs = obs is not None
    offset_free = has_obs and hasattr(obs, "estimator")
    ndo = obs.nd_offsetfree if offset_free else 0
    nd_sim = obs.nd_measured if offset_free else nd_model
    c = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev).to(dtype)
    Fp, Gp, fp = c(model.F), c(model.G), c(model.f_offset)
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
        of, oK, nxo = c(est.f_offset), c(est.K), est.F.shape[0]
    else:
        nxo = 0
    m = engine.ldp.m

    def solve_step(theta, lam, act, side, carry):
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
        T = a.shape[1]
        if T >= T_need:
            return a[:, :T_need, :]
        return torch.cat([a, a[:, -1:, :].expand(B, T_need - T, a.shape[2])], dim=1)

    with torch.no_grad():
        x0s = c(x0s)
        B = x0s.shape[0]
        T_need = N + Np + 1
        rs = traj(rs if nr else None, B, T_need, ny)
        ds = traj(ds, B, T_need, nd_sim)
        ps = traj(ps if np_ else None, B, T_need, max(np_base, 1))
        window = lambda tr, k0, width: tr[:, k0 : k0 + width, :]
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
            U, lam_n, act, side, iters_n, status_n, carry = solve_step(
                theta, lam, act, side, carry)
            lam = lam_n.to(dtype)
            u = U[:, :nu].to(dtype) - xhat @ K.T
            if has_obs:
                xo = xo @ oF.T + u @ oG.T + of + (d_k @ oGd.T if nd_sim else 0.0)
            x_next = x @ Fp.T + u @ Gp.T + fp + (d_k @ Gd.T if nd_sim else 0.0)
            for k, v in (("xs", x), ("us", u), ("ys", y_m), ("iters", iters_n),
                         ("status", status_n)):
                out[k].append(v)
            x, uprev = x_next, u
    return [torch.stack(out[k], dim=1) for k in ("xs", "us", "ys", "iters", "status")]


def _bits(t):
    t = t.contiguous()
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _assert_same(mpc, x0s, rs, ds, ps, N):
    res = build_rollout(mpc)(x0s, rs, ds, ps, N=N)
    ref = _stacked_rollout(mpc, x0s, rs, ds, ps, N)
    for name, got, want in zip(res._fields, res, ref):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.equal(_bits(got), _bits(want)), name
    return res


def _invpend(dtype):
    mpc, _ = tmpc.mpc_examples("invpend")
    return mpc.setup(device="cpu", dtype=dtype)


def _lanes(B, seed, nx=4, ny=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, nx)).astype(np.float32),
            rng.uniform(-1, 1, (B, ny)).astype(np.float32))


@pytest.mark.parametrize("kind", ["constant", "short_trajectory"])
def test_small_tier_rollout_equals_stacked_loop(kind):
    """invpend in float32 (theta = [x; r; u_prev], the small-m tier), 16
    lanes x 12 steps: r one value a lane, or a (B, 5, 2) trajectory held at
    its last step from step 5 on. Every output equal bit for bit, and the
    fields are views of time-major buffers."""
    mpc = _invpend(torch.float32)
    assert mpc.engine.path == "small"
    x0, r = _lanes(16, 11)
    if kind == "short_trajectory":
        r = r[:, None, :] * np.linspace(1.0, 0.2, 5)[None, :, None]
    res = _assert_same(mpc, x0, r, None, None, 12)
    assert res.xs.stride(1) == 16 * 4 and res.status.stride() == (2, 32)
    assert bool((res.status == 1).all())


def test_iu_tier_rollout_equals_stacked_loop():
    """crazyflie in float32 (theta = x, the IU tier's warm step with the
    carried inverse, its plain epilogue on the CPU), 6 lanes x 5 steps."""
    mpc, _ = tmpc.mpc_examples("crazyflie")
    mpc.setup(device="cpu", dtype=torch.float32)
    assert mpc.engine.path == "iu"
    x0 = np.random.default_rng(12).uniform(-1, 1, (6, mpc.model.nx)).astype(np.float32)
    _assert_same(mpc, x0, None, None, None, 5)


def _preview(kind):
    A, B = np.array([[1.0, 1], [0, 1]]), np.array([[0.0], [1]])
    if kind in ("reference", "condensed"):
        mpc = TMPC.from_discrete(A, B, C=np.eye(2), Np=5, Nc=3)
        mpc.set_bounds(umin=[-2.0], umax=[2.0])
        mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
        mpc.settings.reference_preview = True
        mpc.settings.reference_condensation = kind == "condensed"
        r = np.zeros((2, 12, 2))
        r[:, 6:, 0] = [[1.0], [-0.5]]
        return mpc, (np.array([[1.0, 0.0], [0.0, 0.5]]), r, None)
    if kind == "disturbance":
        mpc = TMPC.from_discrete(A, B, Gd=np.array([[0.0], [1]]), C=[[1.0, 0]], Np=5, Nc=5)
        mpc.set_bounds(umin=[-0.5], umax=[0.5])
        mpc.set_objective(Q=[10.0], R=[0.1])
        mpc.settings.disturbance_preview = True
        d = np.zeros((2, 10, 1))
        d[:, 4:, 0] = [[0.4], [-0.3]]
        return mpc, (np.zeros((2, 2)), None, d)
    F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
    mpc = TMPC.from_discrete(F, G, C=np.array([[1.0, 0]]), Gd=np.array([[1.0], [0.0]]),
                             Ts=0.1, Np=20)
    mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
    mpc.set_bounds(umin=[-1.0], umax=[1.0])
    if kind == "kalman":
        mpc.set_state_observer(Q=[1.0, 1.0], R=[0.1])
        return mpc, (np.array([[1.0, 0.0], [0.2, 0.1]]), np.full((2, 1), 0.5), None)
    mpc.set_offset_free_observer(method="velocity", Q=[1e-3, 1e-3], R=[1e-4])
    return mpc, (np.zeros((2, 2)), np.full((2, 1), 0.3), np.full((2, 1), 0.05))


@pytest.mark.parametrize("kind", ["reference", "condensed", "disturbance", "kalman",
                                  "offset_free"])
def test_exact_path_theta_parts_equal_stacked_loop(kind):
    """The exact float64 path, 2 lanes x 16 steps, through each of theta's
    parts: a reference preview window (plain and condensed) and a
    disturbance preview over trajectories shorter than N + Np, a Kalman
    observer with a constant reference, and an offset-free observer with a
    constant measured disturbance beside its estimated channel."""
    mpc, (x0, r, d) = _preview(kind)
    mpc.setup(device="cpu")
    _assert_same(mpc, x0, r, d, None, 16)
