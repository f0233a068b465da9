"""The port's hybrid (binary-control) MPC on the CPU against the JAX
package: K3's resumable step (``iu.step_iu``) against the Pallas stepper
``make_iu_stepper`` in interpret mode; the float32 engine (the incremental
frontier on the plain stepper) against the JAX engine with
``LINEARMPC_TPU_IUPALLAS=interpret``; the float64 pop-per-round frontier
(GI relax and masked-Cholesky relax) and the per-lane depth-first search
against their JAX counterparts; brute-force enumeration; ``MPC``'s
entry points and the closed-loop satellite; the engine's routing.

Tolerances: the step's discrete state (working set, sides, pending row
and side, done, infeas, iterations) equal on every lane, its multipliers
and inverse within the spread of ``tests/test_torch_iu.py`` (float32
summation order); engines: statuses equal and fval within 1e-6 (1 + |f|)
in float32 (branching in float32 may pick another incumbent of equal
value, so U is not compared, ``bnb_frontier.py:28-30``), fval within 1e-8
and U within 1e-7 in float64 (``tests/test_hybrid.py:148-170``).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.mpc import MPC as JaxMPC
from linearmpc_tpu.ops import pallas_iu as P
from linearmpc_tpu.ops.bnb import solve_bnb_single
from linearmpc_tpu.simulation import simulate_kw as jax_simulate_kw
from linearmpc_tpu_torch.mpc import MPC as TorchMPC
from linearmpc_tpu_torch.ops import bnb_frontier, iu
from linearmpc_tpu_torch.ops.bnb import solve_bnb_dfs
from linearmpc_tpu_torch.ops.engine import route
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
from linearmpc_tpu_torch.simulation import simulate_kw

K = 8


@functools.lru_cache(maxsize=None)
def _jax_engine(name, Np, f32):
    """A JAX engine; float32 with the incremental Pallas frontier run
    through the interpreter (the env switch is read while it is built)."""
    old = os.environ.get("LINEARMPC_TPU_IUPALLAS")
    os.environ["LINEARMPC_TPU_IUPALLAS"] = "interpret"
    try:
        mpc, _ = lmpc.mpc_examples(name, Np, Np)
        mpc.setup(dtype=jnp.float32 if f32 else None)
    finally:
        if old is None:
            del os.environ["LINEARMPC_TPU_IUPALLAS"]
        else:
            os.environ["LINEARMPC_TPU_IUPALLAS"] = old
    return mpc.engine


@functools.lru_cache(maxsize=None)
def _port(name, Np, f32):
    mpc, _ = tmpc.mpc_examples(name, Np, Np)
    return mpc.setup(device="cpu", dtype=torch.float32 if f32 else torch.float64)


def _thetas(e, B, seed, lo=1.0):
    return np.random.default_rng(seed).uniform(-lo, lo, (B, e.ldp.n_theta))


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


# -- (a) the resumable K3 step against the Pallas stepper ----------------------

def _step_problem(B=128, seed=0):
    """Satellite Np=20 (m = 60, the hybrid bench's size) in float32: node
    bounds with a random third of the binary rows clamped to one of their
    bounds per lane, and the matching per-lane equality mask."""
    e = _jax_engine("satellite", 20, True)
    m = e.ldp.m
    rng = np.random.default_rng(seed)
    th = jnp.asarray(_thetas(e, B, seed), jnp.float32)
    du = np.asarray(e.arrays.du + th @ e.arrays.Dth.T)
    dl = np.asarray(e.arrays.dl + th @ e.arrays.Dth.T)
    binr = np.asarray(e.ldp.is_binary) & np.asarray(e.ldp.up_finite) & np.asarray(e.ldp.lo_finite)
    fixed = binr[None, :] & (rng.uniform(size=(B, m)) < 0.33)
    up = rng.uniform(size=(B, m)) < 0.5
    d = np.where(up, du, dl)
    du, dl = np.where(fixed, d, du), np.where(fixed, d, dl)
    eq = np.asarray(e.ldp.is_eq)[None, :] | fixed
    return e, du.astype(np.float32), dl.astype(np.float32), eq


def _pallas_steps(e, du, dl, eq, state, calls):
    """``calls`` calls of the Pallas stepper (K iterations each, interpret
    mode) from the lane-major state; returns the state and the last call's
    active steps."""
    m = e.ldp.m
    eps32 = float(np.finfo(np.float32).eps)
    softd = np.asarray(np.asarray(e.ldp.rho_soft, np.float64) + 4 * eps32, np.float32)
    step = P.make_iu_stepper(e.arrays.G, softd, np.asarray(e.ldp.is_immutable, np.float32),
                             m=m, K=K, chunk=128, primal_tol=e.primal_tol,
                             sign_tol=e.sign_tol, interpret=True)
    args = (jnp.asarray(du.T), jnp.asarray(dl.T), jnp.asarray(eq.T, jnp.float32))
    steps = None
    for _ in range(calls):
        state, steps = step(*args, state)
    return tuple(np.asarray(a) for a in state), steps if steps is None else np.asarray(steps)


def _cold_state(B, m):
    zb = torch.zeros((B, m), dtype=torch.bool)
    return iu.IUState(torch.zeros(B, m), zb, ~zb, torch.full((B,), -1),
                      torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
                      torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool),
                      torch.eye(m))


@functools.lru_cache(maxsize=1)
def _mid_search_entry():
    """The state a K3 step enters mid-search: the port's float32 engine on
    satellite Np=20 (B = 128), its incremental frontier run round by round
    until a round enters with lanes holding a pending row and some lanes,
    not all, done; returns that round's node bounds, per-lane eq (branched
    rows clamped) and solver state."""
    eng = _port("satellite", 20, True).engine
    fr = eng.inc_frontier()
    s = fr.init(torch.tensor(_thetas(eng, 128, seed=1)))
    for _ in range(120):
        g = s.gi
        if int((g.pend >= 0).sum()) > 0 and 0 < int(g.done.sum()) < 128:
            break
        s = fr.round(s)
    return s.du_l.numpy(), s.dl_l.numpy(), s.eq_l.numpy(), s.gi


def _signed_pend(st, m):
    out = torch.zeros((st.pend.shape[0], m))
    lanes = torch.nonzero(st.pend >= 0).squeeze(1)
    out[lanes, st.pend[lanes]] = torch.where(st.pend_side[lanes], 1.0, -1.0)
    return out.numpy()


def _lane_major(st, m):
    """The port's batch-major IUState as the Pallas stepper's lane-major
    state (signed one-hot pend; done and infeas repeated over m rows)."""
    B = st.lam.shape[0]
    f = lambda t: jnp.asarray(t.numpy().T.astype(np.float32))
    rows = lambda t: jnp.asarray(np.repeat(t.numpy().astype(np.float32)[None, :], m, 0))
    R = st.R.expand(B, m, m) if st.R.dim() == 2 else st.R
    return (f(st.lam), f(st.act), f(st.side), jnp.asarray(_signed_pend(st, m).T),
            rows(st.done), rows(st.infeas), jnp.asarray(R.reshape(B, m * m).numpy().T))


def _port_step(e, du, dl, eq, state):
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    return iu.step_iu(G, Gs, torch.tensor(du), torch.tensor(dl), torch.tensor(eq),
                      torch.tensor(np.asarray(e.ldp.is_immutable)), state, K=K,
                      primal_tol=e.primal_tol, sign_tol=e.sign_tol)


@pytest.mark.parametrize("entry", ["cold", "mid-search"])
def test_step_iu_matches_pallas_stepper(entry):
    """One K = 8 step of each from the same state: cold, on node bounds
    with random binary rows clamped (per-lane eq); and mid-search, the
    state an incremental-frontier round enters (pending rows, done lanes,
    branched eq)."""
    e = _jax_engine("satellite", 20, True)
    if entry == "cold":
        _, du, dl, eq = _step_problem()
        st0 = _cold_state(*du.shape)
    else:
        du, dl, eq, st0 = _mid_search_entry()
        assert int((st0.pend >= 0).sum()) > 0 and 0 < int(st0.done.sum()) < du.shape[0]
        assert (eq.sum(1) > np.asarray(e.ldp.is_eq).sum()).any()
    B, m = du.shape
    ref, steps = _pallas_steps(e, du, dl, eq, _lane_major(st0, m), 1)
    st, iters = _port_step(e, du, dl, eq, st0)
    assert torch.equal(iters, st.iters)
    assert np.array_equal(iters.numpy(), steps.astype(np.int32))
    assert np.array_equal(st.act.numpy(), ref[1].T > 0.5)
    assert np.array_equal(st.side.numpy(), ref[2].T > 0.5)
    assert np.array_equal(_signed_pend(st, m), ref[3].T)
    assert np.array_equal(st.done.numpy(), ref[4][0] > 0.5)
    assert np.array_equal(st.infeas.numpy(), ref[5][0] > 0.5)
    lam_rel = _rel(st.lam.numpy(), ref[0].T).max(1)
    R_rel = _rel(st.R.numpy(), ref[6].T.reshape(B, m, m)).reshape(B, -1).max(1)
    assert np.median(lam_rel) <= 1e-5 and np.median(R_rel) <= 1e-5
    assert lam_rel.max() <= 1e-1 and R_rel.max() <= 1e-1
    # a lane that entered done ran no iteration and came back unchanged
    d0 = st0.done
    R0 = st0.R.expand(B, m, m)
    assert torch.all(iters[d0] == 0)
    assert torch.equal(st.lam[d0], st0.lam[d0]) and torch.equal(st.R[d0], R0[d0])


def test_step_iu_runs_plain_on_cpu():
    e, du, dl, eq = _step_problem(B=16, seed=2)
    st0 = _cold_state(*du.shape)
    before = (iu.LAUNCHES, iu.STEP_LAUNCHES)
    st, _ = _port_step(e, du, dl, eq, st0)
    assert (iu.LAUNCHES, iu.STEP_LAUNCHES) == before
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    ref, _ = iu.step_iu_plain(G, Gs, torch.tensor(du), torch.tensor(dl), torch.tensor(eq),
                              torch.tensor(np.asarray(e.ldp.is_immutable)), st0, K=K,
                              primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    for a, b in zip(st, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,admitted", [(52, True), (60, True), (66, True), (67, False),
                                        (88, False)])
def test_frontier_routing_budget_matches_jax(m, admitted):
    assert iu.iu_max_chunk_lanes(m, iu.FRONTIER_BUDGET) == P.iu_max_chunk_lanes(m, 20 * 2**20)
    assert (iu.iu_max_chunk_lanes(m, iu.FRONTIER_BUDGET) >= iu.LANES) == admitted


def test_prune_tops_matches_popping_loop():
    """The vectorized count equals popping while the top node's bound
    reaches the incumbent."""
    rng = np.random.default_rng(0)
    B, cap = 64, 9
    top = torch.tensor(rng.integers(0, cap + 1, B))
    bound = torch.tensor(rng.uniform(0, 1, (B, cap)))
    inc = torch.tensor(rng.uniform(0, 1, B))
    found = torch.tensor(rng.uniform(size=B) < 0.8)
    out = bnb_frontier.prune_tops(top, found, inc, bound)
    for b in range(B):
        t = int(top[b])
        while t > 0 and bool(found[b]) and float(bound[b, t - 1]) >= float(inc[b]):
            t -= 1
        assert int(out[b]) == t


# -- (b) the float32 engine against the JAX engine (interpret mode) -----------

@pytest.mark.parametrize("Np", [6, 20])
def test_f32_engine_matches_jax_interpret_frontier(Np):
    """Satellite Np=6 (m = 18, 12 binaries) and Np=20 (m = 60): the port's
    float32 engine runs the incremental frontier on the plain stepper, the
    JAX engine on the Pallas stepper in interpret mode."""
    e_j = _jax_engine("satellite", Np, True)
    assert e_j.frontier_pallas
    eng = _port("satellite", Np, True).engine
    assert eng.path == "hybrid" and eng.bnb_mode == "inc"
    th = _thetas(eng, 16 if Np == 6 else 8, seed=1)
    sol_j = e_j.solve_batch(th)
    sol = eng.solve_batch(th)
    assert np.array_equal(sol.status.numpy(), np.asarray(sol_j.status))
    ok = sol.status.numpy() == 1
    assert ok.all()
    assert _rel(sol.fval.numpy(), np.asarray(sol_j.fval))[ok].max() <= 1e-6


# -- (c) brute-force enumeration, float64 and float32 -------------------------

def _enum_mpc(cls, Np):
    mpc = cls.from_discrete([[1.0, 0.1], [0, 1.0]], [[0.0], [1.0]], Np=Np, Nc=Np)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1], Rr=[0.0])
    mpc.set_bounds(umin=[0.0], umax=[1.0])
    mpc.set_binary_controls([0])
    mpc.settings.reference_tracking = False
    return mpc


def _enumerate(qp, theta, Np):
    f_t = qp.f + qp.f_theta @ theta
    best = (np.inf, None)
    for bits in range(2**Np):
        U = np.array([(bits >> k) & 1 for k in range(Np)], dtype=float)
        val = 0.5 * U @ qp.H @ U + f_t @ U
        if val < best[0]:
            best = (val, U)
    return best


DTYPES = {"f64": torch.float64, "f32": torch.float32}
ENUM_TOL = {"f64": (1e-6, 1e-8), "f32": (1e-5, 1e-6)}  # U, fval (tests/test_hybrid.py)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_single_bnb_matches_enumeration(dt):
    """tests/test_hybrid.py:52-77 on the port (a float64 single runs the
    depth-first search, a float32 one the incremental frontier)."""
    mpc = _enum_mpc(TorchMPC, 3).setup(device="cpu", dtype=DTYPES[dt])
    theta = mpc.form_parameter(np.array([0.3, -0.4]))
    U, fval, flag, _ = mpc.solve(theta)
    assert flag == 1
    val, U_best = _enumerate(mpc.mpQP, theta, 3)
    u_tol, f_tol = ENUM_TOL[dt]
    assert np.allclose(U, U_best, atol=u_tol) and abs(fval - val) < f_tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_batched_bnb_matches_enumeration(dt):
    """tests/test_hybrid.py:173-236: the frontier (float64) and the
    incremental frontier (float32) against enumeration."""
    mpc = _enum_mpc(TorchMPC, 4).setup(device="cpu", dtype=DTYPES[dt])
    eng = mpc.engine
    ths = np.random.default_rng(5).uniform(-1.0, 1.0, (8, eng.ldp.n_theta))
    sol = eng.solve_batch(ths)
    u_tol, f_tol = ENUM_TOL[dt]
    for i in range(len(ths)):
        val, U_best = _enumerate(mpc.mpQP, ths[i], 4)
        assert int(sol.status[i]) == 1
        assert np.allclose(sol.U[i].numpy(), U_best, atol=u_tol), i
        assert abs(float(sol.fval[i]) - val) < f_tol


@pytest.mark.parametrize("relax", ["iu", "cholesky", "kernel"])
def test_frontier_cold_nodes_matches_enumeration(relax):
    """tests/test_hybrid.py:298-332: the frontier with cold node solves
    (incumbents must still pin their fixed rows), with each relax; the
    kernel relax is K3 cold (its plain version here) in float32."""
    f32 = relax == "kernel"
    mpc = _enum_mpc(TorchMPC, 4).setup(device="cpu",
                                       dtype=torch.float32 if f32 else torch.float64)
    eng = mpc.engine
    if f32:
        G, Gs = iu.gram(eng.ldp, torch.float32, "cpu")
        rel = bnb_frontier.make_kernel_relax(G, Gs, eng.arrays.is_immutable, max_iter=100,
                                             primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    else:
        rel = bnb_frontier.make_xla_relax(eng.arrays, max_iter=100, mode=relax,
                                          primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    ths = np.random.default_rng(5).uniform(-1.0, 1.0, (8, eng.ldp.n_theta))
    sol = bnb_frontier.solve_bnb_frontier(eng.arrays, eng.arrays_hi,
                                          torch.tensor(ths), rel, warm_nodes=False)
    for i in range(len(ths)):
        val, U_best = _enumerate(mpc.mpQP, ths[i], 4)
        assert int(sol.status[i]) == 1
        assert np.allclose(sol.U[i].numpy(), U_best, atol=1e-6), i


# -- (d) float64 frontier and depth-first search against JAX ------------------

def test_f64_frontier_and_dfs_match_jax():
    """tests/test_hybrid.py:148-170 across the packages: the frontier (GI
    relax, m = 18) and the per-lane DFS of each against the other's."""
    e_j = _jax_engine("satellite", 6, False)
    eng = _port("satellite", 6, False).engine
    assert eng.bnb_mode == "frontier"
    ths = np.random.default_rng(11).uniform(-1.5, 1.5, (12, eng.ldp.n_theta))
    ref_f = e_j.solve_batch(ths)
    ref_d = e_j._bnb_batched(e_j.arrays, e_j.arrays_hi, np.asarray(ths))
    sol_f = eng.solve_batch(ths)
    sol_d = eng._dfs(torch.tensor(ths))
    for sol, ref in ((sol_f, ref_f), (sol_d, ref_d), (sol_f, ref_d)):
        st = sol.status.numpy()
        assert np.array_equal(st, np.asarray(ref.status))
        ok = st == 1
        assert np.abs(sol.fval.numpy() - np.asarray(ref.fval))[ok].max() < 1e-8
        assert np.abs(sol.U.numpy() - np.asarray(ref.U))[ok].max() < 1e-7


def test_dfs_warm_start_matches_cold():
    """tests/test_hybrid.py:239-267 on the port: warm-started child nodes
    change iteration counts, not solutions (satellite Np=20, 6 lanes).
    The engine's stack (2 nb + 2 nodes) holds the whole depth-first path,
    so every lane finishes its tree (at the JAX test's 16 every lane stops
    at the node limit with status 2, in both packages)."""
    eng = _port("satellite", 20, False).engine
    ths = torch.tensor(np.random.default_rng(3).uniform(-1.5, 1.5, (6, eng.ldp.n_theta)))
    kw = dict(stack_cap=eng.stack_cap, node_limit=1024, primal_tol=eng.primal_tol,
              sign_tol=eng.sign_tol)
    sw = solve_bnb_dfs(eng.arrays, ths, warm_nodes=True, **kw)
    sc = solve_bnb_dfs(eng.arrays, ths, warm_nodes=False, **kw)
    assert torch.equal(sw.status, sc.status)
    ok = sc.status == 1
    assert ok.all()
    assert (sw.fval - sc.fval)[ok].abs().max() < 1e-7
    assert (sw.U - sc.U)[ok].abs().max() < 1e-6
    assert int(sw.iters.sum()) < int(sc.iters.sum())


def test_dfs_single_lane_matches_jax_solve_bnb_single():
    eng = _port("satellite", 6, False).engine
    e_j = _jax_engine("satellite", 6, False)
    th = np.random.default_rng(4).uniform(-1.5, 1.5, eng.ldp.n_theta)
    ref = solve_bnb_single(e_j.arrays, jnp.asarray(th), stack_cap=eng.stack_cap,
                           node_limit=1024)
    sol = solve_bnb_dfs(eng.arrays, torch.tensor(th[None]), stack_cap=eng.stack_cap,
                        node_limit=1024)
    assert int(sol.status[0]) == int(ref.status) == 1
    assert int(sol.iters[0]) == int(ref.iters)
    assert abs(float(sol.fval[0]) - float(ref.fval)) < 1e-8
    assert np.abs(sol.U[0].numpy() - np.asarray(ref.U)).max() < 1e-7


# -- (e) the masked-Cholesky relax on the contact problem ---------------------

def _contact_thetas(B):
    """The first B lanes of invpend_contact (4, 4) at theta in +-0.3,
    default_rng(3) (tests/test_hybrid.py:370-376)."""
    nth = _port("invpend_contact", 4, False).engine.ldp.n_theta
    return np.random.default_rng(3).uniform(-0.3, 0.3, (B, nth))


@functools.lru_cache(maxsize=1)
def _contact_f64():
    """Both float64 engines (the monolithic frontier, Cholesky relax) on
    the first two contact lanes: (thetas, port solution, JAX solution)."""
    ths = _contact_thetas(2)
    sol = _port("invpend_contact", 4, False).engine.solve_batch(ths)
    return ths, sol, _jax_engine("invpend_contact", 4, False).solve_batch(ths)


@functools.lru_cache(maxsize=1)
def _contact_f32():
    """The port's float32 engine at m = 88, the frontier rounds, on four
    contact lanes: (thetas, solution, last round state, rounds)."""
    eng = _port("invpend_contact", 4, True).engine
    ths = _contact_thetas(4)
    sol = eng.solve_batch(ths)
    return ths, sol, eng._rounds.last_state, eng._rounds.rounds


def test_cholesky_frontier_contact_matches_jax():
    """invpend_contact (4, 4), m = 88 > 64: both float64 engines run the
    pop-per-round frontier with the masked-Cholesky relax. Its relaxations
    are massively degenerate (cond(G_solve) ~ 4e17, multipliers ~ 1e8), so
    the two packages' Cholesky round-off moves the multipliers by ~1e-3
    relative from the first iterations on and the node walks differ; these
    two lanes (7140 and 6745 node iterations in the JAX package) end on the
    same optimum."""
    eng = _port("invpend_contact", 4, False).engine
    assert eng.ldp.m == 88 and eng.bnb_mode == "frontier"
    _ths, sol, ref = _contact_f64()
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert np.all(sol.status.numpy() == 1)
    assert np.abs(sol.fval.numpy() - np.asarray(ref.fval)).max() < 1e-8
    assert np.abs(sol.U.numpy() - np.asarray(ref.U)).max() < 1e-7


def _fixed_binary_fval(ldp, theta, lam):
    """The incumbent's binary rows, each on the bound it is nearer, and the
    float64 optimum of the continuous QP with those rows clamped there
    (``solve_ldp_numpy``): (binaries at the upper bound, status, fval)."""
    dt = ldp.Dth @ theta
    c = ldp.G @ lam
    up = (np.where(ldp.up_finite, ldp.du + dt + c, np.inf)
          <= np.where(ldp.lo_finite, -(ldp.dl + dt) - c, np.inf))
    b = np.asarray(ldp.is_binary)
    d = np.where(up, ldp.du, ldp.dl)
    clamped = dataclasses.replace(ldp, du=np.where(b, d, ldp.du), dl=np.where(b, d, ldp.dl),
                                  is_eq=np.asarray(ldp.is_eq) | b)
    U, *_rest, status = solve_ldp_numpy(clamped, theta, max_iter=5000)
    f_t = ldp.f + ldp.f_theta @ theta
    return up[b], status, 0.5 * U @ ldp.H @ U + f_t @ U


def test_f64_contact_frontier_lanes_agree_on_optimum():
    """Pins the settled fault of the float64 Cholesky-relax frontier at
    m = 88: on 16 lanes both packages' node walks differ (their iteration
    counts differ on 14) but no status or fval differs; here, on two such
    lanes, both end on the same working set and binaries, and each
    incumbent is the float64 optimum of its binaries (fval within 1e-10
    (1 + |f|) of the clamped QP's), so neither package pruned wrongly."""
    ldp = _port("invpend_contact", 4, False).engine.ldp
    ths, sol, ref = _contact_f64()
    assert np.array_equal(sol.active.numpy(), np.asarray(ref.active))
    for i, th in enumerate(ths):
        fvals = []
        for lam, fval in ((sol.lam[i].numpy(), float(sol.fval[i])),
                          (np.asarray(ref.lam[i]), float(ref.fval[i]))):
            up, status, f_np = _fixed_binary_fval(ldp, th, lam)
            assert status == 1 and abs(fval - f_np) <= 1e-10 * (1.0 + abs(f_np))
            fvals.append((up, f_np))
        assert np.array_equal(fvals[0][0], fvals[1][0])
        assert abs(fvals[0][1] - fvals[1][1]) <= 1e-12 * (1.0 + abs(fvals[1][1]))


# -- (f) the frontier rounds: float32 hybrid at m >= 67 -----------------------

@pytest.mark.parametrize("case", [
    # satellite m = 60: 8 lanes run to convergence; round-off level
    dict(name="satellite", Np=20, B=8, lo=1.0, iters=60, lam_tol=1e-12, R_tol=1e-12),
    # contact m = 88 (cond(G_solve) ~ 4e17, ||R|| up to 1e8): the walks
    # part after ~15 iterations on some lanes (a degenerate update's
    # round-off decides a sign), so 10 iterations
    dict(name="invpend_contact", Np=4, B=4, lo=0.3, iters=10, lam_tol=1e-6, R_tol=1e-5),
])
def test_wu_loop_matches_jax(case):
    """``_active_set_loop_wu`` (Woodbury + Newton-Schulz maintained ridged
    inverse, ridge 1e-8, the in-loop staleness gate on) against the JAX
    loop from the same entry state and R0, in float64: a random third of
    the binary rows clamped (per-lane eq), cold working sets. The discrete
    state (working set, sides, iterations, done, stale) is equal; lam and R
    agree within float64 round-off amplified by the ridged system's
    conditioning: lam within ``lam_tol`` (1 + |lam|), R within ``R_tol``
    max|R|."""
    from linearmpc_tpu.ops.dual_active_set import _active_set_loop_wu as jax_wu
    from linearmpc_tpu_torch.ops.dual_active_set import _active_set_loop_wu

    e_j = _jax_engine(case["name"], case["Np"], False)
    arr = _port(case["name"], case["Np"], False).engine.arrays
    B, m = case["B"], arr.G.shape[0]
    ths = np.random.default_rng(3).uniform(-case["lo"], case["lo"], (B, arr.Dth.shape[1]))
    rng = np.random.default_rng(4)
    dt = ths @ arr.Dth.numpy().T
    du, dl = arr.du.numpy() + dt, arr.dl.numpy() + dt
    fixed = arr.is_binary.numpy()[None] & (rng.uniform(size=(B, m)) < 0.3)
    d = np.where(rng.uniform(size=(B, m)) < 0.5, du, dl)
    du, dl = np.where(fixed, d, du), np.where(fixed, d, dl)
    eq = arr.is_eq.numpy()[None] | fixed
    lam0, side0 = np.zeros((B, m)), np.ones((B, m), bool)
    fr = bnb_frontier.FrontierRounds(arr, None)
    R0 = fr.seed_R(torch.tensor(eq)).numpy()
    kw = dict(max_iter=case["iters"], primal_tol=1e-6, sign_tol=1e-11, ridge=fr.ridge)
    st, R, stale = _active_set_loop_wu(arr, torch.tensor(du), torch.tensor(dl), torch.tensor(eq),
                                       arr.is_immutable, torch.tensor(lam0), torch.tensor(eq),
                                       torch.tensor(side0), torch.tensor(R0), **kw)
    ref, R_j, stale_j = jax.jit(jax.vmap(lambda a, b, c, d0, e0, f0, g0: jax_wu(
        e_j.arrays, a, b, c, e_j.arrays.is_immutable, d0, e0, f0, g0, **kw)))(
        du, dl, eq, lam0, eq, side0, R0)
    for a, b in ((st.active, ref.active), (st.side, ref.side), (st.iters, ref.iters),
                 (st.done, ref.done), (stale, stale_j)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(st.iters.sum()) > B * 5
    lam_j = np.asarray(ref.lam)
    assert (np.abs(st.lam.numpy() - lam_j) <= case["lam_tol"] * (1.0 + np.abs(lam_j))).all()
    R_j = np.asarray(R_j)
    assert (np.abs(R.numpy() - R_j).max((1, 2)) <= case["R_tol"] * np.abs(R_j).max((1, 2))).all()


def test_frontier_rounds_matches_monolithic():
    """tests/test_hybrid.py:391-430 on the port: the rounds with
    ``reference=True`` (the masked-Cholesky loop in slices of 24
    iterations, the depth-first stack) equal the port's monolithic float64
    frontier bit for bit on two contact lanes; the engine's float32 path
    (Woodbury-maintained inverse, best-first order, stack 98, node cap 400)
    finds the same optima (fval rtol 1e-9, U within 1e-7)."""
    eng = _port("invpend_contact", 4, False).engine
    ths, mono, _ref = _contact_f64()
    sol = bnb_frontier.FrontierRounds(
        eng.arrays, None, stack_cap=eng.stack_cap, node_limit=eng.bnb_node_limit,
        node_cap=eng.node_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol,
        reference=True).solve(ths)
    assert np.all(mono.status.numpy() == 1)
    for a, b in ((sol.status, mono.status), (sol.fval, mono.fval), (sol.U, mono.U)):
        assert torch.equal(a, b)
    _ths, fast, _s, _r = _contact_f32()
    assert torch.equal(fast.status[:2], mono.status)
    assert np.allclose(fast.fval[:2].numpy(), mono.fval.numpy(), rtol=1e-9, atol=1e-9)
    assert np.abs(fast.U[:2].numpy() - mono.U.numpy()).max() <= 1e-7


def test_bnb_status_two_budget_limited():
    """tests/test_hybrid.py:433-458 on the port: a lane that holds an exact
    incumbent but whose search the node limit stopped reports 2, not 1.
    The engine's rounds with the node limit starved to 40 find the same
    optimum as the full search (status 1) on two lanes."""
    ths, full, _s, _r = _contact_f32()
    assert np.all(full.status.numpy() == 1)
    fr = _port("invpend_contact", 4, True).engine._rounds
    starved = bnb_frontier.FrontierRounds(
        fr.arr, fr.arr_hi, stack_cap=fr.stack_cap, node_limit=40, node_cap=fr.node_cap,
        primal_tol=fr.primal_tol, sign_tol=fr.sign_tol).solve(ths[:2])
    assert np.all(starved.status.numpy() == 2)
    assert np.allclose(starved.fval.numpy(), full.fval[:2].numpy(), rtol=1e-9, atol=1e-9)


def test_frontier_rounds_carried_inverse_stats():
    """tests/test_hybrid.py:461-483 on the port: the rounds expose their
    search statistics, and drift-certificate reseeds stay under a quarter
    of the rounds on every lane."""
    _ths, sol, s, rounds = _contact_f32()
    assert np.all(sol.status.numpy() == 1)
    assert rounds > 50
    assert int(s.reseeds.max()) < 0.25 * rounds


def test_f32_contact_engine_matches_jax_frontier_rounds():
    """The float32 engine at m = 88 against the JAX ``make_frontier_rounds``
    called with the JAX engine's accelerator arguments (engine.py:1328-1385)
    on four lanes: statuses equal, fval within 1e-6 (1 + |f|)."""
    from linearmpc_tpu.ops.bnb_frontier import make_frontier_rounds

    e_j = _jax_engine("invpend_contact", 4, True)
    fr = _port("invpend_contact", 4, True).engine._rounds
    ths, sol, _s, _r = _contact_f32()
    ref = make_frontier_rounds(
        e_j.arrays_hi, e_j.arrays_hi, stack_cap=fr.stack_cap, node_limit=fr.node_limit,
        node_cap=fr.node_cap, k_chunk=24, use_cholesky=True, poll_every=4,
        primal_tol=min(e_j.primal_tol, 1e-6), sign_tol=1e-11)(ths)
    assert (fr.stack_cap, fr.node_cap, fr.K_CHUNK, fr.POLL_EVERY) == (98, 400, 24, 4)
    assert np.array_equal(sol.status.numpy(), np.asarray(ref.status))
    assert _rel(sol.fval.numpy(), np.asarray(ref.fval)).max() <= 1e-6


# -- (g) MPC entry points and the closed-loop satellite -----------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_compute_control_matches_jax(dt):
    mpc_j, _ = lmpc.mpc_examples("satellite", 6, 6)
    mpc_t, _ = tmpc.mpc_examples("satellite", 6, 6)
    mpc_t.setup(device="cpu", dtype=DTYPES[dt])
    x, r = [0.1, -0.2, 0.05], [0.5, 0.0, 0.0]
    u_j = mpc_j.compute_control(x, r=r)
    u_t = mpc_t.compute_control(x, r=r)
    assert np.abs(u_t - u_j).max() < (1e-5 if dt == "f32" else 1e-7)
    for b in mpc_t.binary_controls:
        assert min(abs(u_t[b] - mpc_t.umin[b]), abs(u_t[b] - mpc_t.umax[b])) < 1e-5


def test_closed_loop_satellite_matches_jax():
    """tests/test_hybrid.py:11-30 on the port (float64 engine on the CPU:
    every step a depth-first search) beside the JAX package's run."""
    N = 20
    rs = np.vstack([np.hstack([np.zeros((1, 5)), 0.5 * np.ones((1, N - 5))]),
                    np.zeros((2, N))])
    sims = []
    for pkg, sim_fn in ((tmpc, simulate_kw), (lmpc, jax_simulate_kw)):
        mpc, _ = pkg.mpc_examples("satellite", 20)
        mpc.settings.reference_preview = True
        if pkg is tmpc:
            mpc.setup(device="cpu")
        dyn = (lambda mpc: lambda x, u, d: mpc.model.F @ x + mpc.model.G @ np.atleast_1d(u))(mpc)
        sims.append((mpc, sim_fn(mpc, x0=np.zeros(3), N=N, r=rs, dynamics=dyn)))
    (mpc, sim), (_, sim_j) = sims
    assert abs(sim.ys[0, -1] - 0.5) < 1e-3
    for b in mpc.binary_controls:
        on = (np.isclose(sim.us[b, :], mpc.umin[b], atol=1e-5)
              | np.isclose(sim.us[b, :], mpc.umax[b], atol=1e-5))
        assert np.all(on)
    assert np.abs(np.asarray(sim.us) - np.asarray(sim_j.us)).max() < 1e-6


# -- (h) routing ---------------------------------------------------------------

def test_routing_follows_jax_engine():
    """float32: the incremental frontier (m <= 66), the frontier rounds at
    m >= 67; float64: the frontier with the GI relax at m <= 64 and the
    Cholesky relax above, singles by the DFS; the same routes on CUDA."""
    assert _port("satellite", 20, True).engine.bnb_mode == "inc"
    assert _port("satellite", 20, False).engine.bnb_mode == "frontier"
    e64 = _port("invpend_contact", 4, False).engine
    assert e64.ldp.m == 88 and e64.bnb_mode == "frontier"
    e32 = _port("invpend_contact", 4, True).engine
    assert e32.bnb_mode == "rounds" and e32._rounds.arr.G.dtype == torch.float64
    for dev in ("cpu", "cuda"):
        for m, dt, mode in ((60, torch.float32, "inc"), (66, torch.float32, "inc"),
                            (67, torch.float32, "rounds"), (88, torch.float32, "rounds"),
                            (88, torch.float64, "frontier")):
            assert route(dev, dt, m, binaries=True) == ("hybrid", mode)
        assert route(dev, torch.float32, 88, binaries=True, symmetric=False) == ("hybrid", "dfs")


def test_bnb_node_limit_reaches_engine():
    mpc, _ = tmpc.mpc_examples("satellite", 6, 6)
    mpc.settings.solver_opts["bnb_node_limit"] = 3
    eng = mpc.setup(device="cpu").engine
    assert eng.bnb_node_limit == 3
    sol = eng.solve_batch(_thetas(eng, 4, seed=0))
    # the search stopped after 3 nodes: budget-limited or no incumbent yet
    assert set(sol.status.tolist()) <= {2, -1, -2}


def test_non_symmetric_hybrid_runs_dfs():
    """A non-symmetric H (game MPC) with a binary control: the float64
    engine takes the depth-first search (no frontier), as the JAX engine
    does, and both agree."""
    def build(cls):
        mpc = cls.from_discrete([[1.0, 0.1], [0, 1]], [[0.0, 0], [1, 1]], C=np.eye(2), Np=3)
        mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
        mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
        mpc.set_bounds(umin=[0.0, -1.0], umax=[1.0, 1.0])
        mpc.set_binary_controls([0])
        return mpc
    mj, mt = build(JaxMPC), build(TorchMPC).setup(device="cpu")
    mj.setup()
    assert not mt.mpQP.is_symmetric and mt.engine.bnb_mode == "dfs"
    assert not getattr(mj.engine, "use_frontier", True)
    th = mt.form_parameter(np.array([2.0, -1.0]), r=np.array([1.0, 0.0]))
    Uj, fj, sj, _ = mj.solve(th)
    Ut, ft, st, _ = mt.solve(th)
    assert st == sj and abs(ft - fj) < 1e-8 and np.abs(Ut - Uj).max() < 1e-7
    sol = mt.engine.solve_batch(np.stack([th, th]))
    assert torch.all(sol.status == sj)
