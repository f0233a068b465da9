"""The port's large-m tiers on the CPU (their kernels' plain versions):
the IU tier at m = 48 (invpend 30/8 with the +-18 state box on ks 2..11)
and the compact tier at m = 64 (the box on ks 2..15; m = 64 is past K3's
routing rule, so both packages pick the compact tier there), against the
NumPy float64 oracle and the JAX engine, plus their warm rollouts against
the JAX package's fused rollouts in interpret mode
(tests/test_pallas_iu.py:114-144, tests/test_pallas_ciu.py:279-304).

Tolerances: controls within 1e-8 of the oracle wherever it decides a lane
(its own stalls, status -1, are not held against the engine), the JAX
tiers' own bar (tests/test_pallas_iu.py:52); rollout controls within 1e-5,
the bar the JAX package holds its fused large-m rollouts to.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.rollout import build_rollout as jax_build_rollout
from linearmpc_tpu_torch.ops import ciu, iu
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

B = 128
K_HI = {"iu": 12, "compact": 16}  # box on ks 2..K_HI-1: m = 48, 64


def _box(mpc, k_hi):
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    return mpc


def _port(path, **setup):
    mpc, _ = tmpc.mpc_examples("invpend", 30, 8)
    return _box(mpc, K_HI[path]).setup(device="cpu", dtype=torch.float32, **setup)


def _jax(path):
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    return _box(mpc, K_HI[path])


def _thetas(lo=8.0, seed=0, n=B):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-lo, lo, (n, 4)), rng.uniform(-lo, lo, (n, 2)),
                      rng.uniform(-2, 2, (n, 1))])


@functools.lru_cache(maxsize=4)
def _oracle(path, lo, seed):
    ldp = _port(path).engine.ldp
    th = _thetas(lo, seed)
    return th, [solve_ldp_numpy(ldp, t) for t in th]


def _check_oracle(sol, oracle, tol=1e-8):
    st, U = sol.status.numpy(), sol.U.numpy()
    n_ok = 0
    for i, (U_ref, *_r, s_ref) in enumerate(oracle):
        if s_ref == 1:
            n_ok += 1
            assert st[i] == 1, (i, st[i])
            assert np.max(np.abs(U[i] - U_ref)) <= tol, i
        elif s_ref == -3:
            assert st[i] == -3, (i, st[i])
    return n_ok


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_tier_routing(path):
    eng = _port(path).engine
    assert eng.path == path and eng.ldp.m == {"iu": 48, "compact": 64}[path]
    assert (iu.iu_max_chunk_lanes(eng.ldp.m) >= 128) == (path == "iu")


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_tier_matches_oracle(path):
    """Cold batched solves: status and controls against the oracle, and no
    kernel launch on the CPU (the plain versions ran)."""
    eng = _port(path).engine
    th, oracle = _oracle(path, 8.0, 0)
    before = (iu.LAUNCHES, ciu.LAUNCHES)
    sol = eng.solve_batch(th)
    assert (iu.LAUNCHES, ciu.LAUNCHES) == before
    assert _check_oracle(sol, oracle) >= 90
    assert torch.all(sol.status != -1)


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_tier_infeasibility_verdicts(path):
    """A wide box (x, r in +-16): a real mix of feasible and infeasible
    lanes; every lane the oracle decides gets the oracle's verdict."""
    eng = _port(path).engine
    th, oracle = _oracle(path, 16.0, 77)
    sol = eng.solve_batch(th)
    _check_oracle(sol, oracle)
    assert int((sol.status == -3).sum()) >= 10


def test_iu_tier_matches_jax_engine(monkeypatch):
    """Status codes equal to the JAX IU tier's (its Pallas kernel in
    interpret mode) on the same theta; controls of optimal lanes within
    1e-8 of each other."""
    monkeypatch.setenv("LINEARMPC_TPU_IUPALLAS", "interpret")
    mj = _jax("iu")
    mj.setup(dtype=jnp.float32)
    assert mj.engine.use_iu_pallas
    th = _thetas(12.0, 5)
    sol_j = mj.engine.solve_batch(jnp.asarray(th))
    sol_t = _port("iu").engine.solve_batch(th)
    st_j = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.numpy(), st_j)
    ok = st_j == 1
    assert np.max(np.abs(sol_t.U.numpy()[ok] - np.asarray(sol_j.U)[ok])) <= 1e-8


def test_compact_tier_resolves_overflow():
    """Slot capacity 8 (second chance at 16): lanes overflow the bulk
    phase; the second chance and the f64 guards must still return every
    oracle-decided lane exactly (tests/test_pallas_ciu.py:196-216)."""
    eng = _port("compact").engine
    eng.ciu_s_max, eng._ciu_s2 = 8, 16
    th, oracle = _oracle("compact", 8.0, 0)
    sol = eng.solve_batch(th)
    _check_oracle(sol, oracle)
    assert eng.stats["second_chance"] == B and eng.stats["guard"] > 0


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_warm_solve_matches_cold(path):
    """A warm start from the cold solution lands on the same controls in
    fewer iterations (tests/test_pallas_iu.py:76-87)."""
    eng = _port(path).engine
    th = _thetas(8.0, 7)
    cold = eng.solve_batch(th)
    warm = eng.solve_batch(th, warm=(cold.lam, cold.active, cold.side))
    ok = cold.status == 1
    assert torch.equal(warm.status, cold.status)
    assert torch.max(torch.abs(warm.U[ok] - cold.U[ok])).item() <= 1e-8
    assert (warm.iters[ok] <= cold.iters[ok]).double().mean().item() > 0.9


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_rollout_matches_jax_fused(path, monkeypatch):
    """128 x 6 closed loop from x0 in +-3: the port's warm large-m step
    (carried R, or carried slots) against the JAX package's fused
    rollout with its Pallas kernel in interpret mode."""
    env = {"iu": "LINEARMPC_TPU_IUPALLAS", "compact": "LINEARMPC_TPU_CIUPALLAS"}[path]
    monkeypatch.setenv(env, "interpret")
    mj = _jax(path)
    mj.setup(dtype=jnp.float32)
    assert hasattr(mj.engine, {"iu": "fused_rollout_solve_iu",
                               "compact": "fused_rollout_solve_ciu"}[path])
    rng = np.random.default_rng(5)
    x0s = rng.uniform(-3, 3, (B, 4))
    rs = np.zeros((B, 2))
    rj = jax_build_rollout(mj)(x0s, rs, None, N=6)
    rt = tmpc.build_rollout(_port(path))(x0s, rs, None, N=6)
    assert rt.status.double().eq(1).double().mean().item() > 0.99
    assert np.array_equal(rt.status.numpy(), np.asarray(rj.status))
    assert np.max(np.abs(rt.us.numpy() - np.asarray(rj.us))) <= 1e-5
    assert np.max(np.abs(rt.xs.numpy() - np.asarray(rj.xs))) <= 1e-4


@pytest.mark.parametrize("Nc", [11, 12])
def test_float32_tier_gap_raises(Nc):
    """float32 at m = 11-12, between K1's table and the large-m tiers, is
    routed as the JAX package runs it, to batched solve_single (its XLA
    fallback), on the CPU and on the card alike; the CPU engine takes that
    path and solves the golden state (status 1, U within 1e-9 of the
    NumPy oracle)."""
    from linearmpc_tpu_torch.ops.engine import route

    mpc, _ = tmpc.mpc_examples("invpend", 50, Nc)
    mpc.setup(device="cpu", dtype=torch.float32)
    eng = mpc.engine
    assert eng.ldp.m == Nc and eng.path == "single"
    for dev in ("cpu", "cuda"):
        assert route(dev, torch.float32, Nc) == ("single", None)
    th = mpc.form_parameter(np.array([5.0, 5.0, 0.0, 0.0]))
    U, _f, status, _info = mpc.solve(th)
    U_ref, *_rest, s_ref = solve_ldp_numpy(eng.ldp, th)
    assert status == 1 == s_ref
    assert np.abs(U - U_ref).max() <= 1e-9


def test_compact_guard_ladder_resolves():
    """With the bulk caps cut to one iteration, the second chance resolves
    nothing, the f64 guard takes its 64 + 32 lanes and the rest go up the
    escalating ladder (engine.py:877-938), 16 lanes a rung; every lane the
    guard or the ladder returns optimal is exact."""
    eng = _port("compact").engine
    eng.bulk_cap, eng.bulk_cap_p = 1, 1
    th, oracle = _oracle("compact", 8.0, 0)
    sol = eng.solve_batch(th)
    assert eng.stats["guard"] > 0 and eng.stats["ladder"] > 0
    st, U = sol.status.numpy(), sol.U.numpy()
    n_exact = 0
    for i, (U_ref, *_r, s_ref) in enumerate(oracle):
        if s_ref == 1 and st[i] == 1:
            n_exact += 1
            assert np.max(np.abs(U[i] - U_ref)) <= 1e-8, i
    assert n_exact >= 32


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_diverged_residual_ranks_first(path):
    """A lane whose f64 Richardson diverges (NaN multipliers, seen at
    m = 256 where the f32 slot inverse reached |Rw| ~ 1e8) gets an infinite
    KKT residual: it can be neither certified nor skipped by the f64 tiers,
    whatever sign its NaN carries in a sort."""
    eng = _port(path).engine
    m = eng.ldp.m
    th = torch.as_tensor(_thetas(8.0, 3, n=4))
    du_h, dl_h = eng._bounds64(th)
    lam = torch.zeros((4, m), dtype=torch.float64)
    lam[1, 0], lam[2, 0] = torch.nan, -torch.nan
    act = torch.zeros((4, m), dtype=torch.bool)
    act[:, 0] = True
    bad = eng._kkt_bad(lam, act, torch.ones((4, m), dtype=torch.bool), du_h, dl_h)
    assert torch.isfinite(bad[[0, 3]]).all() and torch.all(bad[[1, 2]] == torch.inf)


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_warm_solve_with_indefinite_f32_block(path):
    """A warm working set whose float32 block is not positive definite
    (forced here through row 0 of the float32 G_solve, as round-off can on
    an ill-conditioned set): its Cholesky inverse is NaN instead of an
    exception, as in the JAX package, the lanes go to the float64
    re-solves, and every lane the oracle decides still gets its verdict and
    controls."""
    eng = _port(path).engine
    m = eng.ldp.m
    G = eng.arrays.G_solve.clone()
    G[0, 0] = -1.0
    eng.arrays = eng.arrays._replace(G_solve=G)
    th, oracle = _oracle(path, 8.0, 0)
    act0 = torch.zeros((B, m), dtype=torch.bool)
    act0[::2, :2] = True
    assert torch.isnan(iu.init_R_batch(G, act0)[::2]).all()
    assert torch.isfinite(iu.init_R_batch(G, act0)[1::2]).all()
    sol = eng.solve_batch(th, warm=(torch.zeros((B, m)), act0,
                                    torch.ones((B, m), dtype=torch.bool)))
    _check_oracle(sol, oracle)
    assert torch.all(sol.status != -1)


@pytest.mark.parametrize("name", ["chained", "mass_spring", "ballplate", "crazyflie"])
def test_examples_on_iu_tier_match_jax_f64(name):
    """The repo's examples with 12 < m <= 52 (m = 19, 19, 38, 40) route to
    the IU tier; over their parameter ranges its statuses equal the JAX
    engine's exact float64 path and its controls agree within 1e-8 (on
    ballplate the NumPy oracle itself is off by up to 5e-9, so the f64
    engine is the reference here)."""
    mt, prange = tmpc.mpc_examples(name)
    mt.setup(device="cpu", dtype=torch.float32)
    assert mt.engine.path == "iu"
    mj, _ = lmpc.mpc_examples(name)
    mj.setup()
    lo, hi = prange.lower(), prange.upper()
    th = lo + (hi - lo) * np.random.default_rng(1).uniform(0.0, 1.0, (64, len(lo)))
    sol_t = mt.engine.solve_batch(th)
    sol_j = mj.engine.solve_batch(jnp.asarray(th))
    st_j = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.numpy(), st_j)
    ok = st_j == 1
    assert np.max(np.abs(sol_t.U.numpy()[ok] - np.asarray(sol_j.U)[ok])) <= 1e-8


@pytest.mark.parametrize("path", ["iu", "compact"])
def test_cold_entry_inverse_is_one_matrix(path):
    """A cold batch enters K3/K4 with one entry inverse viewed by every lane
    (batch stride 0), not a materialised (B, n, n) copy."""
    eng = _port(path).engine
    inv = eng.iu_R0_init(64) if path == "iu" else eng._ciu_cold_carry(64)[1]
    n = eng.ldp.m if path == "iu" else eng.ciu_s_max
    assert tuple(inv.shape) == (64, n, n) and inv.stride(0) == 0
    assert torch.equal(inv[0], torch.eye(n))


def test_compact_f64_verdict_needs_finite_multipliers(monkeypatch):
    """The lane of a cold m = 128 batch (B = 8192, theta in +-10) that came
    back -3 with NaN controls on the card. Its float64 G and bounds, as the
    card's host built them (they differ from this machine's by ~1e-15),
    send the f64 guard (s = 32) to its cap undecided and the ladder's first
    pass (s = 96) to an infeasibility flag through an overflowed inverse
    (|Rw| ~ 1e153) with a NaN multiplier. Such a verdict certifies nothing:
    the lane stays unresolved for the next pass (s = 128), which flags it
    infeasible with finite multipliers. The JAX package's guard returns -3
    with finite controls on this lane, and so does the port now."""
    data = np.load(Path(__file__).parent / "data" / "compact_lane1929.npz")
    mpc, _ = tmpc.mpc_examples("invpend", 50, 8)
    eng = _box(mpc, 32).setup(device="cpu", dtype=torch.float32).engine
    assert eng.path == "compact" and eng.ldp.m == 128
    G64 = torch.as_tensor(data["G64"])
    rho = np.asarray(eng.ldp.rho_soft, np.float64)
    eng._G64 = G64
    eng._Gs64 = (torch.as_tensor(data["G64"] + np.diag(rho))
                 + 4.0 * np.finfo(np.float64).eps * torch.eye(128, dtype=torch.float64))
    bounds = (torch.as_tensor(data["du_h"])[None], torch.as_tensor(data["dl_h"])[None])
    monkeypatch.setattr(eng, "_bounds64", lambda th64: bounds)
    # the ladder's first pass alone: the flag with a NaN multiplier
    out = eng._ciu_f64(*bounds, 96, 2 * eng.bulk_cap + 48)
    assert bool(out[5][0]) and not bool(torch.isfinite(out[0]).all())
    sol = eng.solve_batch(data["theta"][None])
    assert eng.stats["guard"] == 1 and eng.stats["ladder"] == 2
    assert int(sol.status[0]) == -3
    assert bool(torch.isfinite(sol.U).all()) and bool(torch.isfinite(sol.lam).all())
