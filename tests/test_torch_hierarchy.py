"""The port's lexicographic hierarchy (``ops/hierarchy.LexSolver``) on the
CPU against the JAX package's: the two-level problem of the JAX bench
(``bench.py:575-602``, m = 7) and the cases of ``tests/test_priority.py``.

Tolerances: statuses and iteration counts equal; U within 1e-9 (both are
the same float64 iteration, level by level, with the same subset tables).
"""

import functools

import numpy as np
import pytest
import torch

from linearmpc_tpu.mpc import MPC as JaxMPC
from linearmpc_tpu_torch.mpc import MPC as TorchMPC
from linearmpc_tpu_torch.ops import bulk
from linearmpc_tpu_torch.ops.dual_active_set import _active_set_loop


def _bench(cls):
    """bench.py:578-585: x >= 1 (priority 0) against x <= -1 (priority 1)."""
    mpc = cls.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1e-6], R=[1e-6])
    mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=0)
    mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=[2, 3], soft=True, prio=1)
    mpc.settings.hierarchy = "lexicographic"
    return mpc


def _conflicted(cls, flip):
    """tests/test_priority.py:11-21 in lexicographic mode."""
    mpc = cls.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1e-6], R=[1e-6])
    p_hi, p_lo = (1, 0) if flip else (0, 1)
    mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=p_hi)
    mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=[2, 3], soft=True, prio=p_lo)
    mpc.settings.hierarchy = "lexicographic"
    return mpc


def _three_level(cls):
    """tests/test_priority.py:46-65: a symmetric level-0 conflict and a
    level-1 row that the frozen violations must not let move x."""
    mpc = cls.from_discrete([[0.0]], [[1.0]], C=[[1.0]], Np=2, Nc=2)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1e-6], R=[1e-6])
    mpc.settings.reference_tracking = False
    mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2], soft=True, prio=0)
    mpc.add_constraint(Ax=[[2.0]], ub=[-2.0], ks=[2], soft=True, prio=0)
    mpc.add_constraint(Ax=[[4.0]], lb=[2.0], ks=[2], soft=True, prio=1)
    mpc.settings.hierarchy = "lexicographic"
    return mpc


def _unconflicted(cls):
    """tests/test_priority.py:117-126."""
    mpc = cls.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1.0], R=[0.1])
    mpc.add_constraint(Ax=[[1.0]], ub=[2.0], ks=[2, 3], soft=True, prio=0)
    mpc.add_constraint(Ax=[[1.0]], ub=[3.0], ks=[2, 3], soft=True, prio=1)
    mpc.settings.hierarchy = "lexicographic"
    return mpc


CASES = {
    "bench": _bench,
    "conflicted": functools.partial(_conflicted, flip=False),
    "conflicted_flipped": functools.partial(_conflicted, flip=True),
    "three_level": _three_level,
    "unconflicted": _unconflicted,
}


@functools.lru_cache(maxsize=None)
def _pair(case, dtype=torch.float64):
    mj = CASES[case](JaxMPC)
    mj.setup()
    mt = CASES[case](TorchMPC)
    mt.setup(device="cpu", dtype=dtype)
    return mj, mt


def _thetas(mpc, B, seed, lo=2.0):
    return np.random.default_rng(seed).uniform(-lo, lo, (B, mpc.engine.ldp.n_theta))


def _assert_match(sol, ref):
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert np.array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    assert np.abs(sol.U.numpy() - np.asarray(ref.U)).max() <= 1e-9


@pytest.mark.parametrize("case", list(CASES))
def test_lex_batch_matches_jax(case):
    """256 lanes of theta in +-2 (the bench's range) through both engines'
    solve_batch: the same levels, statuses and iterations, U within 1e-9."""
    mj, mt = _pair(case)
    eng = mt.engine
    assert eng.path == "lex" and len(eng.lex.levels) == len(mj.engine.lex.levels) >= 2
    th = _thetas(mt, 256, seed=0)
    sol = eng.solve_batch(th)
    _assert_match(sol, mj.engine.solve_batch(th))
    if case == "bench":
        assert eng.ldp.m == 7 and bool((sol.status == 1).all())


@pytest.mark.parametrize("case", ["conflicted", "conflicted_flipped", "three_level"])
def test_lex_single_solve_matches_jax(case):
    """MPC.solve at theta = form_parameter(0): the priority that wins the
    conflict (tests/test_priority.py:24-35, :68-108) and the JAX answer."""
    mj, mt = _pair(case)
    th = mt.form_parameter([0.0], r=[0.0]) if case != "three_level" else mt.form_parameter([0.0])
    U, _f, st, _ = mt.solve(th)
    Uj, _fj, stj, _ = mj.solve(th)
    assert st == stj == 1
    assert np.abs(U - np.asarray(Uj)).max() <= 1e-9
    x1 = U[0]
    if case == "conflicted":
        assert x1 > 0.9
    elif case == "conflicted_flipped":
        assert x1 < -0.9
    else:
        assert abs(x1) < 2e-6  # level 0 balances at 0, level 1 cannot move it


def test_lex_is_float64_whatever_the_engine_dtype():
    """A float32 engine runs the same float64 hierarchy."""
    _, m64 = _pair("bench")
    _, m32 = _pair("bench", torch.float32)
    assert m32.engine.path == "lex" and m32.engine.lex.base.G.dtype == torch.float64
    th = _thetas(m64, 64, seed=1)
    a, b = m64.engine.solve_batch(th), m32.engine.solve_batch(th)
    assert a.U.dtype == b.U.dtype == torch.float64
    assert torch.equal(a.U, b.U) and torch.equal(a.status, b.status)


@pytest.mark.parametrize("case", ["bench", "three_level"])
def test_level_kernel_branch_matches_loop(case):
    """What a level runs on CUDA at m <= 10, K1's float64 instantiation
    with the level's subset table and host masks (its plain version here),
    equals the float64 loop of the CPU branch bit for bit, level by level
    from the same entry state."""
    _, mt = _pair(case)
    lex = mt.engine.lex
    base = lex.base
    th = torch.as_tensor(_thetas(mt, 128, seed=2))
    dt = th @ base.Dth.T
    du, dl = base.du + dt, base.dl + dt
    B, m = du.shape
    assert m <= bulk.MAX_M
    lam = torch.zeros((B, m), dtype=torch.float64)
    act = base.is_eq.expand(B, m).clone()
    side = torch.ones((B, m), dtype=torch.bool)
    kw = dict(max_iter=lex.iter_limit, primal_tol=lex.primal_tol, sign_tol=lex.sign_tol)
    for arrays, _mask in lex.level_arrays:
        k1 = bulk.phase1_plain(arrays.subset_inv, arrays.G, du, dl, arrays.is_eq_host,
                               arrays.is_immutable_host, lam, act, side, **kw)
        loop = _active_set_loop(arrays, du, dl, lam, act, side, use_cholesky=True, **kw)
        for a, b in zip(k1, loop):
            assert torch.equal(a, b)
        lam, act, side = loop.lam, loop.active | base.is_eq, loop.side
