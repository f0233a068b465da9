"""The port's batched closed-loop rollout against the JAX package's, on the
CPU: the exact float64 path step for step, and the float32 small-m tier
(the plain versions of its kernels) within float32 drift."""

import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.mpc import MPC as JMPC
from linearmpc_tpu.rollout import build_rollout as jax_build_rollout
from linearmpc_tpu_torch.mpc import MPC as TMPC
from linearmpc_tpu_torch.rollout import build_rollout


def _invpend_lanes(B=8, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (B, 4)), rng.uniform(-1, 1, (B, 2))


def _jax_us(x0s, rs, N):
    mpc, _ = lmpc.mpc_examples("invpend")
    mpc.setup()
    res = jax_build_rollout(mpc)(x0s, rs, None, N=N)
    return np.asarray(res.us), np.asarray(res.status)


def test_invpend_rollout_matches_jax_f64():
    """B=8, N=50 on the exact float64 path: controls within 1e-8 of the
    JAX rollout (both f64; the bar the JAX package holds its rollout to
    against its host loop, tests/test_rollout.py:42)."""
    x0s, rs = _invpend_lanes()
    us_j, st_j = _jax_us(x0s, rs, 50)
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float64)
    res = build_rollout(mpc)(x0s, rs, None, N=50)
    assert res.us.shape == (8, 50, 1) and res.xs.shape == (8, 50, 4)
    assert np.max(np.abs(res.us.numpy() - us_j)) < 1e-8
    assert np.array_equal(res.status.numpy(), st_j)


def test_invpend_rollout_f32_tier_within_f32_drift():
    """The float32 tier carries its state in float32, as the JAX rollout
    does on the TPU (rollout.py:92,211), so it drifts from the f64 rollout
    at f32 round-off: 1e-5 * (1 + |u|), with every status 1."""
    x0s, rs = _invpend_lanes()
    us_j, _st = _jax_us(x0s, rs, 50)
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float32)
    res = build_rollout(mpc)(x0s, rs, None, N=50)
    assert res.us.dtype == torch.float32
    assert torch.all(res.status == 1)
    us = res.us.double().numpy()
    assert np.all(np.abs(us - us_j) <= 1e-5 * (1.0 + np.abs(us_j)))


def _observer_mpc(cls):
    F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
    mpc = cls.from_discrete(F, G, C=np.array([[1.0, 0]]), Ts=0.1, Np=15)
    mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
    mpc.set_bounds(umin=[-1.0], umax=[1.0])
    mpc.set_state_observer(Q=[1.0, 1.0], R=[0.1])
    return mpc


def test_kalman_observer_rollout_matches_jax():
    """The Kalman-observer case of tests/test_rollout.py:46-64, port against
    the JAX rollout and the port's own host loop."""
    x0 = np.array([[1.0, 0.0]])
    mj = _observer_mpc(JMPC)
    mj.setup()
    us_j = np.asarray(jax_build_rollout(mj)(x0, np.array([[0.5]]), None, N=40).us)
    mt = _observer_mpc(TMPC)
    mt.setup(device="cpu")
    res = build_rollout(mt)(x0, np.array([[0.5]]), None, N=40)
    assert np.max(np.abs(res.us.numpy() - us_j)) < 1e-8
    sim = tmpc.simulate_kw(_observer_mpc(TMPC).setup(device="cpu"), x0=x0[0], N=40, r=[0.5])
    assert np.max(np.abs(res.us.numpy()[0].T - sim.us)) < 1e-8


def _preview_mpc(cls, kind):
    A, B = np.array([[1.0, 1], [0, 1]]), np.array([[0.0], [1]])
    if kind == "reference":
        mpc = cls.from_discrete(A, B, C=np.eye(2), Np=5, Nc=3)
        mpc.set_bounds(umin=[-2.0], umax=[2.0])
        mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
        mpc.settings.reference_preview = True
    elif kind == "disturbance":
        mpc = cls.from_discrete(A, B, Gd=np.array([[0.0], [1]]), C=[[1.0, 0]], Np=5, Nc=5)
        mpc.set_bounds(umin=[-0.5], umax=[0.5])
        mpc.set_objective(Q=[10.0], R=[0.1])
        mpc.settings.disturbance_preview = True
    else:  # offset-free observer with a measured disturbance channel
        F, G = np.array([[1.0, 0.1], [0, 1]]), np.array([[0.005], [0.1]])
        mpc = cls.from_discrete(F, G, C=np.array([[1.0, 0]]), Gd=np.array([[1.0], [0.0]]),
                                Ts=0.1, Np=20)
        mpc.set_objective(Q=[1.0], R=[0.0], Rr=[0.1])
        mpc.set_bounds(umin=[-1.0], umax=[1.0])
        mpc.set_offset_free_observer(method="velocity", Q=[1e-3, 1e-3], R=[1e-4])
    return mpc


@pytest.mark.parametrize("kind", ["reference", "disturbance", "offset_free"])
def test_preview_and_offset_free_rollouts_match_jax(kind):
    """Theta assembly (rollout.py:166-205): preview windows and the
    offset-free estimate merged into theta, port against JAX."""
    N = 20
    if kind == "reference":
        r = np.zeros((2, N))
        r[0, 10:] = 1.0
        args = (np.array([[1.0, 0.0]]), r.T[None], None)
    elif kind == "disturbance":
        d = np.hstack([np.zeros((1, 8)), np.ones((1, 12))])
        args = (np.zeros((1, 2)), None, d.T[None])
    else:
        args = (np.zeros((1, 2)), np.full((1, 1), 0.3), np.full((1, 1), 0.05))
    mj = _preview_mpc(JMPC, kind)
    mj.setup()
    us_j = np.asarray(jax_build_rollout(mj)(*args, N=N).us)
    mt = _preview_mpc(TMPC, kind)
    mt.setup(device="cpu")
    us_t = build_rollout(mt)(*args, N=N).us.numpy()
    assert np.max(np.abs(us_t - us_j)) < 1e-8
