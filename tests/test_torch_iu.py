"""K3's plain version (``ops/iu.py``) against the Pallas GI inverse-update
kernel (``linearmpc_tpu/ops/pallas_iu.py``) run through the Mosaic
interpreter on the CPU, and its float64 iteration against the XLA loop
``_active_set_loop_iu``, at the JAX tests' shape: invpend Np=30, Nc=8 with
the +-18 state box on ks 2..11 (m = 48), B = 128
(tests/test_pallas_iu.py:15-27).

Tolerances: from the same entry state the discrete state (working set,
sides, pending candidate, done, infeasible, iteration count) must be
equal on every lane. The float32 multipliers and the carried inverse R
differ by the summation order of the two implementations (index order
here, XLA's blocked matmuls there), amplified through the Woodbury
updates by the conditioning of the working set (about eps32 * cond(M),
with cond(M) up to ~1e6 on the degenerate sets near rank(G)): the median
lane agrees to 1e-5 relative, the worst within 1e-1 after the iteration
cap. The JAX package accepts the same spread between its Pallas and XLA
paths and compares them only through the polished controls
(tests/test_pallas_ciu.py:111-122).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops import pallas_iu as P
from linearmpc_tpu.ops.dual_active_set import _active_set_loop_iu
from linearmpc_tpu_torch.ops import iu

B = 128
CAP = 2 * 48 + 24  # the IU tier's bulk cap at m = 48


@functools.lru_cache(maxsize=1)
def _problem():
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, 12))
    mpc.setup(dtype=jnp.float32)
    return mpc.engine


def _bounds(e, dtype, seed=0, lo=8.0):
    rng = np.random.default_rng(seed)
    th = np.hstack([rng.uniform(-lo, lo, (B, 4)), rng.uniform(-lo, lo, (B, 2)),
                    rng.uniform(-2, 2, (B, 1))])
    arr = e.arrays if dtype == jnp.float32 else e.arrays_hi
    P_ = jax.lax.Precision.HIGHEST
    th_j = jnp.asarray(th, dtype)
    du = arr.du + jnp.dot(th_j, arr.Dth.T, precision=P_)
    dl = arr.dl + jnp.dot(th_j, arr.Dth.T, precision=P_)
    return np.asarray(du), np.asarray(dl)


@functools.partial(jax.jit, static_argnames=("m", "k", "ptol", "stol"))
def _pallas_state(G, softd, du, dl, eq, immut, act0, R0, *, m, k, ptol, stol):
    """k iterations of the Pallas kernel (interpret mode) from a cold
    multiplier state; the full kernel state, pending row included."""
    n = du.shape[0]
    z = jnp.zeros((n, m), jnp.float32)
    ones = jnp.ones((n, m), jnp.float32)
    (Tt, Tr, Sg, Gd, sd, du_l, dl_l, eq_c, im_c, lam_l, act_l, side_l, R_l) = P._prep(
        G, softd, du, dl, eq, immut, z, act0, ones, R0, m)
    call = P._build_call(m, n, ptol, stol, 3.5e-4, True)

    def step(carry, _):
        out = call(Tt, Tr, Sg, Gd, sd, du_l, dl_l, eq_c, im_c, *carry)
        return tuple(out), 1.0 - carry[4][0]

    zl = jnp.zeros((m, n), jnp.float32)
    final, steps = jax.lax.scan(step, (lam_l, act_l, side_l, zl, zl, zl, R_l), None, length=k)
    return final, jnp.sum(steps, axis=0)


def _signed_pend(st, m):
    """The port's (pend, pend_side) as the Pallas kernel's signed one-hot."""
    out = torch.zeros((st.pend.shape[0], m))
    lanes = torch.nonzero(st.pend >= 0).squeeze(1)
    out[lanes, st.pend[lanes]] = torch.where(st.pend_side[lanes], 1.0, -1.0)
    return out.numpy()


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


def _run_both(e, eq, act0, R0, k, du, dl):
    m = e.ldp.m
    eps32 = float(np.finfo(np.float32).eps)
    softd = np.asarray(np.asarray(e.ldp.rho_soft, np.float64) + 4 * eps32, np.float32)
    immut = np.asarray(e.arrays.is_immutable)
    (lam, act, side, pend, done, infeas, R), iters = _pallas_state(
        e.arrays.G, softd, du, dl, np.asarray(eq, np.float32), immut.astype(np.float32),
        np.asarray(act0, np.float32), R0, m=m, k=k, ptol=e.primal_tol, stol=e.sign_tol)
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    st = iu.iterate_iu(G, Gs, torch.tensor(du), torch.tensor(dl), torch.tensor(eq),
                       torch.tensor(immut), torch.zeros(B, m),
                       torch.tensor(np.asarray(act0)), torch.ones(B, m, dtype=torch.bool),
                       torch.tensor(np.asarray(R0)), max_iter=k,
                       primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    ref = dict(lam=np.asarray(lam).T, act=np.asarray(act).T > 0.5,
               side=np.asarray(side).T > 0.5, pend=np.asarray(pend).T,
               done=np.asarray(done)[0] > 0.5, infeas=np.asarray(infeas)[0] > 0.5,
               iters=np.asarray(iters).astype(np.int32),
               R=np.asarray(R).T.reshape(B, m, m))
    return ref, st


def _assert_state(ref, st, m, tail):
    assert np.array_equal(st.act.numpy(), ref["act"])
    assert np.array_equal(st.side.numpy(), ref["side"])
    assert np.array_equal(_signed_pend(st, m), ref["pend"])
    assert np.array_equal(st.done.numpy(), ref["done"])
    assert np.array_equal(st.infeas.numpy(), ref["infeas"])
    assert np.array_equal(st.iters.numpy(), ref["iters"])
    lam_rel = _rel(st.lam.numpy(), ref["lam"]).max(1)
    R_rel = _rel(st.R.numpy(), ref["R"]).reshape(B, -1).max(1)
    assert np.median(lam_rel) <= 1e-5 and np.median(R_rel) <= 1e-5
    assert lam_rel.max() <= tail and R_rel.max() <= tail


@pytest.mark.parametrize("k", [1, 2, 4, CAP])
def test_phase1_iu_plain_matches_pallas(k):
    """After k iterations from the IU tier's cold start (R0 = I)."""
    e = _problem()
    m = e.ldp.m
    du, dl = _bounds(e, jnp.float32)
    eq = np.asarray(e.arrays.is_eq)
    act0 = np.broadcast_to(eq, (B, m))
    R0 = np.broadcast_to(np.eye(m, dtype=np.float32), (B, m, m))
    ref, st = _run_both(e, eq, act0, R0, k, du, dl)
    assert ref["done"].mean() > (0.9 if k == CAP else 0.0)
    _assert_state(ref, st, m, 1e-4 if k <= 4 else 1e-1)


def test_phase1_iu_plain_per_lane_eq():
    """A per-lane equality mask (B, m), as branch-and-bound nodes pass it
    (pallas_iu.py:328-332): each lane clamps one input row to equality,
    entering with it active and R0 from init_R_batch."""
    e = _problem()
    m = e.ldp.m
    du, dl = _bounds(e, jnp.float32, seed=4)
    eq = np.zeros((B, m), bool)
    eq[np.arange(B), np.arange(B) % 8] = True
    R0 = np.asarray(P.init_R_batch(e.arrays.G_solve, jnp.asarray(eq)))
    ref, st = _run_both(e, eq, eq, R0, 20, du, dl)
    _assert_state(ref, st, m, 1e-1)


def test_phase1_iu_dispatch_runs_plain_on_cpu():
    e = _problem()
    m = e.ldp.m
    du, dl = (torch.tensor(a) for a in _bounds(e, jnp.float32, seed=5))
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    args = (G, Gs, du, dl, torch.tensor(np.asarray(e.arrays.is_eq)),
            torch.tensor(np.asarray(e.arrays.is_immutable)), torch.zeros(B, m),
            torch.zeros(B, m, dtype=torch.bool), torch.ones(B, m, dtype=torch.bool),
            torch.eye(m).expand(B, m, m))
    kw = dict(max_iter=CAP, primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    before = iu.LAUNCHES
    out = iu.phase1_iu(*args, **kw)
    assert iu.LAUNCHES == before
    for a, b in zip(out, iu.phase1_iu_plain(*args, **kw)):
        assert torch.equal(a, b)


def test_iterate_iu_f64_matches_xla_loop():
    """The float64 iteration (the tier's straggler re-solve) against the
    vmapped XLA loop from the same cold start: equal discrete state and
    iteration counts, multipliers to float64 round-off."""
    e = _problem()
    hi = e.arrays_hi
    m = e.ldp.m
    du, dl = _bounds(e, jnp.float64, seed=6)
    kw = dict(max_iter=CAP + 24, primal_tol=1e-6, sign_tol=1e-11)
    st_j = jax.vmap(lambda a, b: _active_set_loop_iu(
        hi, a, b, hi.is_eq, hi.is_immutable, jnp.zeros(m), hi.is_eq,
        jnp.ones(m, bool), **kw))(jnp.asarray(du), jnp.asarray(dl))
    G, Gs = iu.gram(e.ldp, torch.float64, "cpu")
    eq = torch.tensor(np.asarray(hi.is_eq))
    act0 = eq.expand(B, m)
    Gsolve = torch.tensor(np.asarray(hi.G_solve))
    st = iu.iterate_iu(G, Gs, torch.tensor(du), torch.tensor(dl), eq,
                       torch.tensor(np.asarray(hi.is_immutable)),
                       torch.zeros(B, m, dtype=torch.float64), act0,
                       torch.ones(B, m, dtype=torch.bool), iu.init_R_batch(Gsolve, act0), **kw)
    assert np.array_equal(st.act.numpy(), np.asarray(st_j.active))
    assert np.array_equal(st.side.numpy(), np.asarray(st_j.side))
    assert np.array_equal(st.done.numpy(), np.asarray(st_j.done))
    assert np.array_equal(st.infeas.numpy(), np.asarray(st_j.infeas))
    assert np.array_equal(st.iters.numpy(), np.asarray(st_j.iters))
    assert _rel(st.lam.numpy(), np.asarray(st_j.lam)).max() <= 1e-9


def test_init_R_batch_matches_jax():
    """Masked working-set inverses of random 4-row working sets (below
    rank(G) = 8, where the inverse is not set by the ridge), to float32
    round-off of a Cholesky inverse relative to each lane's largest entry."""
    e = _problem()
    m = e.ldp.m
    rng = np.random.default_rng(7)
    act = np.zeros((16, m), bool)
    for row in act:
        row[rng.choice(m, 4, replace=False)] = True
    R_j = np.asarray(P.init_R_batch(e.arrays.G_solve, jnp.asarray(act)))
    R_t = iu.init_R_batch(torch.tensor(np.asarray(e.arrays.G_solve)), torch.tensor(act))
    err = np.abs(R_t.numpy() - R_j).reshape(16, -1).max(1)
    assert np.all(err <= 1e-4 * np.abs(R_j).reshape(16, -1).max(1))


@pytest.mark.parametrize("m", [5, 20, 48, 52, 53, 64, 128])
def test_iu_max_chunk_lanes_matches_jax(m):
    assert iu.iu_max_chunk_lanes(m) == P.iu_max_chunk_lanes(m)


@pytest.mark.parametrize("kind", ["matrix", "expanded", "batch"])
def test_entry_inverse_goes_in_once(kind):
    """One (n, n) entry inverse, or a batch that views one matrix, reaches
    the kernels once with batch stride 0 (no (B, n, n) copy); any other
    batch goes in whole, contiguous."""
    eye = torch.eye(6)
    inv = {"matrix": eye, "expanded": eye.expand(5, 6, 6),
           "batch": eye.repeat(5, 1, 1).transpose(1, 2)}[kind]
    t, stride = iu.entry_inverse(inv)
    assert t.is_contiguous() and torch.equal(t.reshape(-1, 6, 6)[0], eye)
    assert stride == (36 if kind == "batch" else 0)
    assert tuple(t.shape) == ((5, 6, 6) if kind == "batch" else (6, 6))
    assert tuple(iu.batch_inverse(inv, 5).shape) == (5, 6, 6)


def test_phase1_iu_takes_one_entry_inverse():
    """phase1_iu and its plain version take one (m, m) entry inverse for
    every lane and give what the expanded batch gives."""
    e = _problem()
    m = e.ldp.m
    du, dl = (torch.tensor(a) for a in _bounds(e, jnp.float32, seed=6))
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    args = (G, Gs, du, dl, torch.tensor(np.asarray(e.arrays.is_eq)),
            torch.tensor(np.asarray(e.arrays.is_immutable)), torch.zeros(B, m),
            torch.zeros(B, m, dtype=torch.bool), torch.ones(B, m, dtype=torch.bool))
    kw = dict(max_iter=CAP, primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    one = iu.phase1_iu(*args, torch.eye(m), **kw)
    for a, b in zip(one, iu.phase1_iu_plain(*args, torch.eye(m).expand(B, m, m), **kw)):
        assert torch.equal(a, b)
