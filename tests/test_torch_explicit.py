"""Explicit MPC in the port (``linearmpc_tpu_torch/explicit.py``) against
the JAX package's (``linearmpc_tpu/explicit.py``), on the CPU
(``device="cpu"``), float64.

Parity is defined by region sets and region data, not by LP iterates:
the same sorted active sets, per region Ath, bth, F and g within 1e-9;
``evaluate``, ``evaluate_batch`` and ``evaluate_tree`` within 1e-9 of
the JAX package's on 64 sampled theta; the explicit law within 1e-6 of
the port's implicit ``compute_control`` with at most 5 misses in 100
(the JAX package's own contract, ``tests/test_explicit.py``).
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch import explicit

GOLDEN_U = 1.7612519326


@pytest.fixture(scope="module")
def invpend():
    """(JAX controller, port batch-oracle controller, port host-oracle
    controller) of invpend over its default range."""
    mj, rj = lmpc.mpc_examples("invpend")
    mj.setup()
    mt, rt = tmpc.mpc_examples("invpend")
    mt.setup(device="cpu")
    return (lmpc.build_explicit(mj, prange=rj), tmpc.build_explicit(mt, prange=rt),
            tmpc.build_explicit(mt, prange=rt, oracle="host"))


def _thetas(B, seed):
    """x in +-15, r in +-15, u_prev in +-2 (``tests/test_explicit.py:43-60``)."""
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-15, 15, (B, 4)), rng.uniform(-15, 15, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


@pytest.mark.parametrize("oracle", ["batch", "host"])
def test_region_sets_match_jax(invpend, oracle):
    e_j, e_b, e_h = invpend
    e_t = e_b if oracle == "batch" else e_h
    sets = sorted(cr.active_set for cr in e_t.regions)
    assert sets == sorted(cr.active_set for cr in e_j.regions)
    assert len(sets) == 93
    assert e_t.device == torch.device("cpu")
    if oracle == "batch":
        assert e_t.stats["ipm_chunks"] >= 5 and e_t.stats["ipm_lanes"] >= len(sets)
        assert 0 < e_t.stats["highs"] < e_t.stats["ipm_lanes"]
    else:
        assert e_t.stats["ipm_chunks"] == 0 and e_t.stats["highs"] >= len(sets)


def test_region_data_matches_jax(invpend):
    e_j, e_t, _e_h = invpend
    by_as = {cr.active_set: cr for cr in e_j.regions}
    for cr in e_t.regions:
        ref = by_as[cr.active_set]
        for name in ("Ath", "bth", "F", "g"):
            a, b = getattr(cr, name), getattr(ref, name)
            assert a.shape == b.shape
            assert np.max(np.abs(a - b), initial=0.0) <= 1e-9, name


@pytest.mark.parametrize("how", ["evaluate", "evaluate_batch", "evaluate_tree"])
def test_evaluation_matches_jax(invpend, how):
    """The same u as the JAX package on 64 sampled theta (1e-9); the
    tree at its default leaf size."""
    e_j, e_t, _e_h = invpend
    th = _thetas(64, seed=6)
    if how == "evaluate_batch":
        u, viol = e_t.evaluate_batch(th)
        u_j, viol_j = e_j.evaluate_batch(th)
        assert u.dtype == torch.float64 and u.device.type == "cpu" and u.shape == (64, 1)
        assert np.max(np.abs(u.numpy() - np.asarray(u_j))) <= 1e-9
        assert np.max(np.abs(viol.numpy() - np.asarray(viol_j))) <= 1e-9
        return
    n_found = 0
    for t in th:
        u, u_j = getattr(e_t, how)(t), getattr(e_j, how)(t)
        assert (u is None) == (u_j is None)
        if u is not None:
            assert np.max(np.abs(u - u_j)) <= 1e-9
            n_found += 1
    assert n_found >= 58


def test_evaluate_batch_chunking_and_tensors(invpend, monkeypatch):
    """Chunking B changes the result by round-off only (1e-12: the matrix
    product's blocking may differ); tensors are accepted; a point inside a
    region gives the host ``evaluate``'s u."""
    _e_j, e_t, _e_h = invpend
    th = _thetas(50, seed=2)
    u, viol = e_t.evaluate_batch(th)
    monkeypatch.setattr(explicit, "EVAL_BLOCK_BYTES", 7 * len(e_t.regions) * 8 * 10)
    u_c, viol_c = e_t.evaluate_batch(torch.as_tensor(th))
    assert torch.allclose(u, u_c, rtol=0, atol=1e-12)
    assert torch.allclose(viol, viol_c, rtol=0, atol=1e-12)
    for i in np.where(viol.numpy() < 1e-8)[0]:
        assert np.max(np.abs(u[i].numpy() - e_t.evaluate(th[i]))) <= 1e-9


def test_explicit_matches_implicit(invpend):
    """The explicit law within 1e-6 of the port's implicit controller (the
    exact float64 path on the CPU); at most 5 misses in 100."""
    _e_j, e_t, _e_h = invpend
    mpc = e_t.mpc
    rng = np.random.default_rng(5)
    n_miss = 0
    for _ in range(100):
        x, r, up = rng.uniform(-15, 15, 4), rng.uniform(-15, 15, 2), rng.uniform(-2, 2, 1)
        u_imp = mpc.compute_control(x, r=r, uprev=up)
        u_exp = e_t.evaluate(mpc.form_parameter(x, r=r, uprev=up))
        if u_exp is None:
            n_miss += 1
            continue
        assert np.max(np.abs(u_imp - u_exp)) < 1e-6
    assert n_miss <= 5
    assert np.linalg.norm(e_t.compute_control([5.0, 5.0, 0.0, 0.0], uprev=[0.0])
                          - GOLDEN_U) < 1e-6


def test_explicit_game_theoretic():
    """Game-theoretic (non-symmetric H) explicit MPC matches the port's
    implicit controller in closed loop through the port's ``simulate_kw``
    (``tests/test_explicit.py::test_explicit_game_theoretic``)."""

    def build():
        mpc = tmpc.MPC.from_discrete(np.array([[1.0, 0.1], [0, 1]]),
                                     np.array([[0.0, 0], [1, 1]]), C=np.eye(2), Np=10)
        mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
        mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
        mpc.set_bounds(umin=-np.ones(2), umax=np.ones(2))
        mpc.move_block([1, 1, 8])
        return mpc

    mpc = build()
    mpc.setup(device="cpu")
    assert not np.allclose(mpc.mpQP.H, mpc.mpQP.H.T)
    empc = tmpc.build_explicit(mpc, prange=mpc.parameter_range())
    assert empc is not None and len(empc.regions) >= 1
    imp = build()
    imp.setup(device="cpu")
    sim_imp = tmpc.simulate_kw(imp, x0=10 * np.ones(2), r=[10, 0], N=500)
    sim_exp = tmpc.simulate_kw(empc, x0=10 * np.ones(2), r=[10, 0], N=500)
    assert np.max(np.abs(sim_imp.us - sim_exp.us)) < 1e-4
    assert abs(sim_exp.ys[0, -1] - 10.0) < 1e-4
    assert abs(sim_exp.ys[1, -1]) < 1e-4


def test_explicit_device_follows_the_engine(monkeypatch):
    """No device named: the engine's device where the problem is set up;
    a problem never set up goes to the card, which raises without CUDA."""
    mpc, prange = tmpc.mpc_examples("dcmotor")
    mpc.setup(device="cpu")
    empc = tmpc.build_explicit(mpc, prange=prange)
    assert empc.device == torch.device("cpu")
    u, _viol = empc.evaluate_batch(np.zeros((3, empc.nth)))
    assert u.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fresh, prange = tmpc.mpc_examples("dcmotor")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmpc.build_explicit(fresh, prange=prange)
