"""The port's batched ``solve_single`` and the engine paths it serves, on
the CPU against the JAX package on the same numpy inputs:

* ``dual_active_set.solve_single`` against the JAX ``solve_single``
  (vmapped) with each engine's keywords, invpend at m = 5, 11 and 48, in
  float32 with the float64 continuation and in float64 without: statuses
  equal on every lane, U within 1e-9 where the status is 1;
* a single solve (``MPC.solve``) of an infeasible point in float32: -3 in
  both packages, the point certified infeasible by a linear program;
* the float32 engine at m = 0 (the closed form; the JAX float32 engine
  cannot be built there, so against the JAX ``solve_single`` and float64
  engine) and at m = 11-12 against the JAX float32 engine's
  ``solve_batch``;
* the game MPC (a non-symmetric H), without and with its binary control,
  in float32 against the JAX float32 engine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.mpc import MPC as JaxMPC
from linearmpc_tpu.ops import dual_active_set as jdas
from linearmpc_tpu_torch.mpc import MPC as TorchMPC
from linearmpc_tpu_torch.ops import bulk, iu
from linearmpc_tpu_torch.ops.dual_active_set import solve_single

F32 = {True: (torch.float32, jnp.float32), False: (torch.float64, None)}


def _invpend(pkg, m):
    """invpend at m = 5 (the default), 11 (Nc = 11) or 48 (Np = 50, Nc = 8
    with the +-18 state box on ks 2..11, bench.py:308-310)."""
    if m == 48:
        mpc, _ = pkg.mpc_examples("invpend", 50, 8)
        mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                           ks=range(2, 12))
        return mpc
    mpc, _ = pkg.mpc_examples("invpend", *((50, m) if m != 5 else (None, None)))
    return mpc


@functools.lru_cache(maxsize=None)
def _pair(m, f32):
    """(JAX engine, port engine) for invpend at m in one dtype."""
    tdt, jdt = F32[f32]
    mj = _invpend(lmpc, m)
    mj.setup(dtype=jdt)
    mt = _invpend(tmpc, m)
    mt.setup(device="cpu", dtype=tdt)
    assert mt.engine.ldp.m == m
    return mj.engine, mt.engine


def _thetas(B, seed, box=20.0):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-box, box, (B, 6)), rng.uniform(-2, 2, (B, 1))])


def _jax_single(e_j, ths):
    kw = e_j._solve_kw
    return jax.vmap(lambda th: jdas.solve_single(e_j.arrays, th, ldp_hi=e_j.arrays_hi,
                                                 **kw))(jnp.asarray(ths))


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("m", [5, 11, 48])
def test_solve_single_matches_jax(m, f32):
    """Each engine's own keywords: float32 with the f64 continuation (at
    m = 48 the bulk phase is the GI inverse-update loop, K3's plain version
    against the JAX XLA loop; at m = 5 it is K1's plain version), float64
    the exact loop. x, r in +-12 at m = 48 (about 8% infeasible lanes)."""
    e_j, eng = _pair(m, f32)
    ths = _thetas(32, seed=m, box=12.0 if m == 48 else 20.0)
    ref = _jax_single(e_j, ths)
    sol = solve_single(eng.arrays, torch.as_tensor(ths), **eng._single_kw)
    assert eng._single_kw["bulk_inverse_updates"] == (f32 and m == 48)
    st = sol.status.numpy()
    assert np.array_equal(st, np.asarray(ref.status))
    ok = st == 1
    assert ok.sum() >= 24
    assert np.abs(sol.U.numpy() - np.asarray(ref.U))[ok].max() <= 1e-9
    if m == 48:
        assert (st == -3).any()


def _box_mpc(pkg):
    """invpend with the +-2 state box on ks 2..3 (m = 13): from x, r in
    +-20 most points are infeasible."""
    mpc, _ = pkg.mpc_examples("invpend")
    mpc.add_constraint(Ax=np.eye(4), lb=-2 * np.ones(4), ub=2 * np.ones(4), ks=[2, 3])
    return mpc


def _lp_infeasible(mpc, theta) -> bool:
    """An independent certificate: no U satisfies bl + W theta <= [I; A] U
    <= bu + W theta (HiGHS)."""
    q = mpc.mpQP
    E = q.extended_A()
    up, lo = q.bu + q.W @ theta, q.bl + q.W @ theta
    fu, fl = np.isfinite(up), np.isfinite(lo)
    res = linprog(np.zeros(E.shape[1]), A_ub=np.vstack([E[fu], -E[fl]]),
                  b_ub=np.hstack([up[fu], -lo[fl]]), bounds=(None, None), method="highs")
    return res.status == 2


def test_infeasible_point_single_solve_reports_minus3():
    """A float32 single solve goes through ``solve_single`` with the float64
    continuation in both packages (engine.py:1444): on an infeasible point
    both return -3 (the port's batched tier at m = 13 does too). The
    NumPy oracle gives no certificate there (status -1), so the point is
    certified infeasible by a linear program."""
    mj, mt = _box_mpc(lmpc), _box_mpc(tmpc)
    mj.setup(dtype=jnp.float32)
    mt.setup(device="cpu", dtype=torch.float32)
    assert mt.engine.ldp.m == 13 and mt.engine._single_kw["bulk_inverse_updates"]
    ths = _thetas(2, seed=1)
    before = (bulk.LAUNCHES, iu.LAUNCHES)
    for th in ths:
        assert _lp_infeasible(mt, th)
        assert mj.solve(th)[2] == -3
        U, fval, status, info = mt.solve(th)
        assert status == -3 and np.isfinite(U).all()
    assert (bulk.LAUNCHES, iu.LAUNCHES) == before  # plain versions on the CPU
    assert torch.all(mt.engine.solve_batch(ths).status == -3)
    # a feasible point of the same problem is solved (status 1) in both
    th = mt.form_parameter(np.array([0.5, 0.0, 0.0, 0.0]))
    assert mt.solve(th)[2] == 1 == mj.solve(np.asarray(th))[2]


def _m0(cls):
    """A double integrator with no constraint (m = 0)."""
    mpc = cls.from_discrete([[1.0, 0.1], [0.0, 1.0]], [[0.0], [1.0]], C=np.eye(2), Np=5, Nc=3)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
    return mpc


def test_f32_engine_at_m0_is_the_closed_form():
    """float32 at m = 0: the "single" path's closed form (float64, status
    1), equal to the JAX ``solve_single`` with the float64 arrays and to the
    JAX float64 engine within 1e-12. The JAX float32 engine itself cannot be
    built at m = 0 (engine.py:131-133 divides by m^2)."""
    mt = _m0(TorchMPC).setup(device="cpu", dtype=torch.float32)
    eng = mt.engine
    assert eng.ldp.m == 0 and eng.path == "single"
    with pytest.raises(ZeroDivisionError):
        _m0(JaxMPC).setup(dtype=jnp.float32)
    mj = _m0(JaxMPC)
    mj.setup()
    ths = np.random.default_rng(0).uniform(-1.0, 1.0, (8, eng.ldp.n_theta))
    sol = eng.solve_batch(ths)
    a32 = jdas.to_device_arrays(mj.engine.ldp, jnp.float32)
    ref = jax.vmap(lambda th: jdas.solve_single(a32, th, ldp_hi=mj.engine.arrays))(
        jnp.asarray(ths))
    ref64 = mj.engine.solve_batch(jnp.asarray(ths))
    assert torch.all(sol.status == 1) and sol.U.dtype == torch.float64
    for r in (ref, ref64):
        assert np.abs(sol.U.numpy() - np.asarray(r.U)).max() <= 1e-12
        assert np.array_equal(np.asarray(r.status), np.ones(8))
    U, fval, status, _ = eng.solve(ths[0])
    assert status == 1 and np.abs(U - np.asarray(ref.U[0])).max() <= 1e-12


@pytest.mark.parametrize("m", [11, 12])
def test_f32_engine_m11_12_matches_jax_engine(m):
    """float32 at m = 11-12 (beyond K1's table, within the subset cache):
    batched ``solve_single`` with the float64 continuation against the JAX
    float32 engine's ``solve_batch`` (its vmapped XLA ``solve_single``),
    cold and warm: statuses equal, U within 1e-9."""
    e_j, eng = _pair(m, True)
    assert eng.path == "single"
    ths = _thetas(64, seed=m)
    ref = e_j.solve_batch(jnp.asarray(ths))
    sol = eng.solve_batch(ths)
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert torch.all(sol.status == 1)
    assert np.abs(sol.U.numpy() - np.asarray(ref.U)).max() <= 1e-9
    ths2 = ths + np.random.default_rng(1).uniform(-0.05, 0.05, ths.shape)
    warm = eng.solve_batch(ths2, warm=(sol.lam, sol.active, sol.side))
    ref2 = e_j.solve_batch(jnp.asarray(ths2), warm=(ref.lam, ref.active, ref.side))
    assert np.array_equal(warm.status.numpy(), np.asarray(ref2.status))
    assert np.abs(warm.U.numpy() - np.asarray(ref2.U)).max() <= 1e-9


def _game(cls, binary):
    """The game MPC of tests/test_torch_hybrid.py (two players, a
    non-symmetric H), optionally with player 0's control binary."""
    mpc = cls.from_discrete([[1.0, 0.1], [0, 1]], [[0.0, 0], [1, 1]], C=np.eye(2), Np=3)
    mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
    mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
    mpc.set_bounds(umin=[0.0, -1.0], umax=[1.0, 1.0])
    if binary:
        mpc.set_binary_controls([0])
    return mpc


@pytest.mark.parametrize("binary", [False, True])
def test_game_mpc_f32_matches_jax(binary):
    """A non-symmetric H in float32: without the binary the small-m tier
    (K1 and K2 assume nothing symmetric: rows of G, H and the table), with
    it the float32 depth-first search then the float64 re-solve of its
    incumbents; against the JAX float32 engine (its ``solve_batch`` and
    ``solve``): statuses equal, U within 1e-9 (1e-7 with the binary, as
    the float64 DFS test)."""
    mj, mt = _game(JaxMPC, binary), _game(TorchMPC, binary)
    mj.setup(dtype=jnp.float32)
    mt.setup(device="cpu", dtype=torch.float32)
    eng = mt.engine
    assert not mt.mpQP.is_symmetric
    assert (eng.path, eng.bnb_mode) == (("hybrid", "dfs") if binary else ("small", None))
    tol = 1e-7 if binary else 1e-9
    rng = np.random.default_rng(2)
    ths = np.stack([mt.form_parameter(rng.uniform(-2, 2, 2), r=rng.uniform(-1, 1, 2))
                    for _ in range(8)])
    ref = mj.engine.solve_batch(jnp.asarray(ths))
    sol = eng.solve_batch(ths)
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert torch.all(sol.status == 1)
    assert np.abs(sol.U.numpy() - np.asarray(ref.U)).max() <= tol
    Uj, fj, sj, _ = mj.solve(ths[0])
    Ut, ft, st, _ = mt.solve(ths[0])
    assert st == sj == 1 and np.abs(Ut - Uj).max() <= tol
