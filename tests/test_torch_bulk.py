"""K1, the bulk dual active-set phase: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and its float64 XLA loop.

The CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``),
where it is held against ``phase1_plain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops import dual_active_set as jdas
from linearmpc_tpu.ops.ldp import precompute_subset_inverses
from linearmpc_tpu.ops.pallas_solver import phase1_pallas, phase1_pallas_while
from linearmpc_tpu_torch.ops import bulk
from linearmpc_tpu_torch.ops.dual_active_set import finish_from_state, to_device_arrays

PTOL, STOL = 2e-5, 1e-6  # the float32 tier's tolerance floors (engine.py:68-70)


def _case(Np=None, Nc=None, B=128, seed=0):
    """Cold bulk-phase inputs as tests/test_rollout.py:121-132 builds them."""
    mpc, _ = lmpc.mpc_examples("invpend", Np, Nc)
    mpc.setup(dtype=jnp.float32)
    eng = mpc.engine
    ldp, m = eng.ldp, eng.ldp.m
    rng = np.random.default_rng(seed)
    thetas = np.hstack([
        rng.uniform(-20, 20, (B, 4)), rng.uniform(-20, 20, (B, 2)),
        rng.uniform(-2, 2, (B, 1)),
    ]).astype(np.float32)
    du_t = (ldp.du + thetas @ ldp.Dth.T).astype(np.float32)
    dl_t = (ldp.dl + thetas @ ldp.Dth.T).astype(np.float32)
    return eng, thetas, du_t, dl_t


def _jax_phase1(eng, du_t, dl_t, max_iter, fn=phase1_pallas):
    ldp, m = eng.ldp, eng.ldp.m
    B = du_t.shape[0]
    out = fn(
        eng._subset_inv.reshape(2**m, m * m).T, ldp.G, du_t, dl_t,
        ldp.is_eq.astype(float), ldp.is_immutable.astype(float),
        np.zeros((B, m)), np.tile(ldp.is_eq.astype(float), (B, 1)), np.ones((B, m)),
        m=m, n_subsets=2**m, max_iter=max_iter, primal_tol=PTOL, sign_tol=STOL,
        interpret=True,
    )
    return [np.asarray(a) for a in out]


def _port_phase1(eng, du_t, dl_t, max_iter, dtype=torch.float32, ptol=PTOL, stol=STOL):
    ldp, m = eng.ldp, eng.ldp.m
    B = du_t.shape[0]
    out = bulk.phase1_plain(
        torch.as_tensor(eng._subset_inv).to(dtype), torch.as_tensor(ldp.G).to(dtype),
        torch.as_tensor(du_t).to(dtype), torch.as_tensor(dl_t).to(dtype),
        torch.as_tensor(ldp.is_eq), torch.as_tensor(ldp.is_immutable),
        torch.zeros((B, m), dtype=dtype), torch.as_tensor(ldp.is_eq).expand(B, m),
        torch.ones((B, m), dtype=torch.bool),
        max_iter=max_iter, primal_tol=ptol, sign_tol=stol,
    )
    return [a.numpy() for a in out]


@pytest.mark.parametrize("k", [1, 2, 4, 30])
def test_phase1_plain_matches_pallas_per_iteration(k):
    """After k iterations from the same cold state the discrete state is
    equal on every lane. lam* is summed over k in the Pallas order
    (pallas_solver.py:118-124) in float32, so lam agrees to a few f32 ulps
    of the largest term: 1e-5 * (1 + |lam|)."""
    eng, _th, du_t, dl_t = _case()
    lam_j, act_j, side_j, it_j, done_j = _jax_phase1(eng, du_t, dl_t, k)
    lam_t, act_t, side_t, it_t, done_t = _port_phase1(eng, du_t, dl_t, k)
    assert np.array_equal(act_t, act_j)
    assert np.array_equal(side_t, side_j)
    assert np.array_equal(done_t, done_j)
    assert np.array_equal(it_t, it_j)
    assert np.all(np.abs(lam_t - lam_j) <= 1e-5 * (1.0 + np.abs(lam_j)))
    if k == 30:
        assert done_t.all()


def test_phase1_plain_matches_pallas_while():
    """The early-exit variant gives the fixed scan's result; so does the
    port's per-lane freeze."""
    eng, _th, du_t, dl_t = _case(seed=1)
    lam_j, act_j, side_j, it_j, done_j = _jax_phase1(
        eng, du_t, dl_t, 30, fn=phase1_pallas_while)
    lam_t, act_t, side_t, it_t, done_t = _port_phase1(eng, du_t, dl_t, 30)
    assert np.array_equal(act_t, act_j) and np.array_equal(side_t, side_j)
    assert np.array_equal(done_t, done_j) and np.array_equal(it_t, it_j)
    assert np.all(np.abs(lam_t - lam_j) <= 1e-5 * (1.0 + np.abs(lam_j)))


def test_phase1_plain_m8_agreement():
    """m=8 as tests/test_rollout.py:230-259: working sets agree on at least
    98% of lanes and done holds on at least 99%, the bar the JAX package
    sets between its own Pallas and XLA paths (f32 near-ties may flip)."""
    eng, _th, du_t, dl_t = _case(50, 8)
    assert eng.ldp.m == 8
    _lj, act_j, side_j, _ij, done_j = _jax_phase1(eng, du_t, dl_t, 52)
    _lt, act_t, side_t, _it, done_t = _port_phase1(eng, du_t, dl_t, 52)
    agree = np.mean(np.all(act_t == act_j, axis=1) & np.all(side_t == side_j, axis=1))
    assert agree >= 0.98
    assert np.mean(done_t) >= 0.99


def test_phase1_plain_f64_matches_finish_from_state():
    """The float64 instantiation is the straggler continuation: against the
    JAX f64 loop through finish_from_state (dual_active_set.py:779) from
    the same f32 bulk state. Discrete state exact; lam and U to 1e-10,
    the f64 round-off of differently ordered sums."""
    eng, thetas, du_t, dl_t = _case(seed=2)
    lam32, act32, side32, it32, _d = _port_phase1(eng, du_t, dl_t, 3)  # mid-solve state
    mpc64, _ = lmpc.mpc_examples("invpend")
    mpc64.setup()
    arr = mpc64.engine.arrays
    th64 = thetas.astype(np.float64)
    sol_j = jax.vmap(lambda th, l, a, s, i: jdas.finish_from_state(
        arr, th, l, a, s, i, max_iter=24))(
        jnp.asarray(th64), jnp.asarray(lam32.astype(np.float64)), jnp.asarray(act32),
        jnp.asarray(side32), jnp.asarray(it32))
    arr_t = to_device_arrays(mpc64.engine.ldp, torch.float64, "cpu", eng._subset_inv)
    sol_t = finish_from_state(arr_t, torch.as_tensor(th64), torch.as_tensor(lam32),
                              torch.as_tensor(act32), torch.as_tensor(side32),
                              torch.as_tensor(it32), max_iter=24)
    assert np.array_equal(sol_t.active.numpy(), np.asarray(sol_j.active))
    assert np.array_equal(sol_t.side.numpy(), np.asarray(sol_j.side))
    assert np.array_equal(sol_t.iters.numpy(), np.asarray(sol_j.iters))
    assert np.array_equal(sol_t.status.numpy(), np.asarray(sol_j.status))
    assert np.max(np.abs(sol_t.lam.numpy() - np.asarray(sol_j.lam))) <= 1e-10
    assert np.max(np.abs(sol_t.U.numpy() - np.asarray(sol_j.U))) <= 1e-10


def test_phase1_cpu_wrapper_runs_plain_without_launching():
    eng, _th, du_t, dl_t = _case(B=16)
    before = bulk.LAUNCHES
    args = [torch.as_tensor(a) for a in (eng._subset_inv.astype(np.float32),
                                         eng.ldp.G.astype(np.float32), du_t, dl_t)]
    m = eng.ldp.m
    out = bulk.phase1(*args, torch.as_tensor(eng.ldp.is_eq),
                      torch.as_tensor(eng.ldp.is_immutable), torch.zeros(16, m),
                      torch.zeros(16, m, dtype=torch.bool), torch.ones(16, m, dtype=torch.bool),
                      max_iter=30, primal_tol=PTOL, sign_tol=STOL)
    ref = _port_phase1(eng, du_t, dl_t, 30)
    assert bulk.LAUNCHES == before
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bulk.phase1(*(a.to("meta") for a in args), torch.as_tensor(eng.ldp.is_eq),
                    torch.as_tensor(eng.ldp.is_immutable), torch.zeros(16, m, device="meta"),
                    torch.zeros(16, m, dtype=torch.bool, device="meta"),
                    torch.ones(16, m, dtype=torch.bool, device="meta"),
                    max_iter=30, primal_tol=PTOL, sign_tol=STOL)



@pytest.mark.parametrize("case", [("invpend", None, None), ("nonlinear", None, None)])
def test_finish_from_state_host_masks_match_jax(case, monkeypatch):
    """finish_from_state hands K1 the host copies of the masks (no device
    sync on the card) and still gives the JAX package's f64 continuation
    from the same f32 bulk state; nonlinear has equality rows."""
    mpc, prange = lmpc.mpc_examples(*case)
    mpc.setup()
    arr = mpc.engine.arrays
    ldp = mpc.engine.ldp
    B, m = 64, ldp.m
    lo, hi = np.asarray(prange.lower()), np.asarray(prange.upper())
    th = lo + (hi - lo) * np.random.default_rng(3).uniform(0.0, 1.0, (B, len(lo)))
    subset = precompute_subset_inverses(ldp)
    du_t = (ldp.du + th @ ldp.Dth.T).astype(np.float32)
    dl_t = (ldp.dl + th @ ldp.Dth.T).astype(np.float32)
    eq = torch.as_tensor(ldp.is_eq)
    lam32, act32, side32, it32, _d = (a.numpy() for a in bulk.phase1_plain(
        torch.as_tensor(subset).float(), torch.as_tensor(ldp.G).float(), torch.as_tensor(du_t),
        torch.as_tensor(dl_t), eq, torch.as_tensor(ldp.is_immutable), torch.zeros((B, m)),
        eq.expand(B, m), torch.ones((B, m), dtype=torch.bool), max_iter=2, primal_tol=PTOL,
        sign_tol=STOL))
    sol_j = jax.vmap(lambda t, l, a, s, i: jdas.finish_from_state(arr, t, l, a, s, i, max_iter=24))(
        jnp.asarray(th), jnp.asarray(lam32.astype(np.float64)), jnp.asarray(act32),
        jnp.asarray(side32), jnp.asarray(it32))
    arr_t = to_device_arrays(ldp, torch.float64, "cpu", subset)
    seen = []
    phase1 = bulk.phase1
    monkeypatch.setattr(bulk, "phase1", lambda *a, **k: seen.append(a[4:6]) or phase1(*a, **k))
    sol_t = finish_from_state(arr_t, torch.as_tensor(th), torch.as_tensor(lam32),
                              torch.as_tensor(act32), torch.as_tensor(side32),
                              torch.as_tensor(it32), max_iter=24)
    assert len(seen) == 1
    assert seen[0][0] is arr_t.is_eq_host and seen[0][1] is arr_t.is_immutable_host
    assert all(t.device.type == "cpu" for t in seen[0])
    assert np.array_equal(arr_t.is_eq_host.numpy(), ldp.is_eq)
    for name in ("active", "side", "iters", "status"):
        assert np.array_equal(getattr(sol_t, name).numpy(), np.asarray(getattr(sol_j, name)))
    assert np.max(np.abs(sol_t.lam.numpy() - np.asarray(sol_j.lam))) <= 1e-10
    assert np.max(np.abs(sol_t.U.numpy() - np.asarray(sol_j.U))) <= 1e-10


def test_row_bits_cached_until_modified():
    """The kernels' eq/immut bit masks are computed once per host mask
    tensor and again after an in-place change; a mask on another device
    raises rather than sync."""
    flags = torch.tensor([True, False, True, False, False])
    assert bulk.row_bits(flags) == 0b101
    assert flags._row_bits == (flags._version, 0b101)
    assert bulk.row_bits(flags) == 0b101
    flags[4] = True
    assert bulk.row_bits(flags) == 0b10101
    with pytest.raises(ValueError, match="host tensors"):
        bulk.row_bits(flags.to("meta"))
