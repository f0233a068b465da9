"""K4's plain version (``ops/ciu.py`` over ``ops/compact_iu.py``) against
the Pallas compact kernel (``linearmpc_tpu/ops/pallas_ciu.py``) run
through the Mosaic interpreter on the CPU, at the JAX tests' shape (invpend
30/8 with the +-18 state box on ks 2..11, m = 48, B = 128,
tests/test_pallas_ciu.py:31-146): at s = 24 slots and at s = 8, where
lanes overflow. The slot map is compared with the kernel's one-hot SEL
through ``sel_from_slots``. Tolerances as in tests/test_torch_iu.py: the
discrete state equal on every lane, multipliers and the slot inverse
within 1e-5 relative on the median lane and 1e-1 on the worst.

Also: the slot capacities (``slot_capacities``) against a JAX engine built
with ``LINEARMPC_TPU_CIUPALLAS=interpret``, and the compact carry init.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops import pallas_ciu as P
from linearmpc_tpu_torch.ops import ciu, iu

B = 128


def _mpc(k_hi=12):
    mpc, _ = lmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    return mpc


@functools.lru_cache(maxsize=1)
def _problem():
    mpc = _mpc()
    mpc.setup(dtype=jnp.float32)
    return mpc.engine


def _thetas(lo, seed):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-lo, lo, (B, 4)), rng.uniform(-lo, lo, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


@pytest.mark.parametrize("s,lo,seed,k", [(24, 8.0, 0, 3), (24, 8.0, 0, 120),
                                         (8, 14.0, 9, 120)])
def test_phase1_ciu_plain_matches_pallas(s, lo, seed, k):
    e = _problem()
    m = e.ldp.m
    arr = e.arrays
    P_ = jax.lax.Precision.HIGHEST
    th = jnp.asarray(_thetas(lo, seed), jnp.float32)
    du = np.asarray(arr.du + jnp.dot(th, arr.Dth.T, precision=P_))
    dl = np.asarray(arr.dl + jnp.dot(th, arr.Dth.T, precision=P_))
    eps32 = float(np.finfo(np.float32).eps)
    softd = np.asarray(np.asarray(e.ldp.rho_soft, np.float64) + 4 * eps32, np.float32)
    eq = np.asarray(arr.is_eq)
    immut = np.asarray(arr.is_immutable)
    act0 = np.broadcast_to(eq, (B, m))
    Rw0, SEL0, _ = P.init_compact_batch(arr.G_solve, jnp.asarray(act0), s)
    out = P.phase1_ciu_pallas_while(
        arr.G, softd, du, dl, eq.astype(np.float32), immut.astype(np.float32),
        np.zeros((B, m), np.float32), act0.astype(np.float32), np.ones((B, m), np.float32),
        SEL0, Rw0, m=m, s=s, max_iter=k, primal_tol=e.primal_tol, sign_tol=e.sign_tol,
        interpret=True, retry_infeas=False)
    lam, act, side, iters, done, infeas, ovf, SEL, Rw = (np.asarray(o) for o in out)

    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    slots0 = ciu.slots_from_sel(torch.tensor(np.asarray(SEL0)).reshape(B, s, m))
    o = ciu.phase1_ciu(G, Gs, torch.tensor(du), torch.tensor(dl), torch.tensor(eq),
                       torch.tensor(immut), torch.zeros(B, m), torch.tensor(act0),
                       torch.ones(B, m, dtype=torch.bool), slots0,
                       torch.tensor(np.asarray(Rw0)), max_iter=k,
                       primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    assert np.array_equal(o[1].numpy(), act)
    assert np.array_equal(o[2].numpy(), side)
    assert np.array_equal(o[3].numpy(), iters)
    assert np.array_equal(o[4].numpy(), done)
    assert np.array_equal(o[5].numpy(), infeas)
    assert np.array_equal(o[6].numpy(), ovf)
    assert np.array_equal(ciu.sel_from_slots(o[7], m).numpy(), SEL.reshape(B, s, m) > 0.5)
    if s == 8:
        assert ovf.any()  # the capacity really is too small for some lanes
    lam_rel = _rel(o[0].numpy(), lam).max(1)
    Rw_rel = _rel(o[8].numpy(), Rw).reshape(B, -1).max(1)
    assert np.median(lam_rel) <= 1e-5 and np.median(Rw_rel) <= 1e-5
    assert lam_rel.max() <= 1e-1 and Rw_rel.max() <= 1e-1


def test_init_compact_batch_matches_jax():
    """Slot assignment equal, slot inverse to float32 round-off, on entry
    working sets of 4 random rows (below rank(G) = 8)."""
    e = _problem()
    m, s = e.ldp.m, 16
    rng = np.random.default_rng(3)
    act = np.zeros((16, m), bool)
    for row in act:
        row[rng.choice(m, 4, replace=False)] = True
    Rw_j, SEL_j, ovf_j = P.init_compact_batch(e.arrays.G_solve, jnp.asarray(act), s)
    Rw_t, sl_t, ovf_t = ciu.init_compact_batch(
        torch.tensor(np.asarray(e.arrays.G_solve)), torch.tensor(act), s)
    assert np.array_equal(ciu.sel_from_slots(sl_t, m).numpy(),
                          np.asarray(SEL_j).reshape(16, s, m) > 0.5)
    assert np.array_equal(ovf_t.numpy(), np.asarray(ovf_j))
    Rw_j = np.asarray(Rw_j)
    err = np.abs(Rw_t.numpy() - Rw_j).reshape(16, -1).max(1)
    assert np.all(err <= 1e-4 * np.abs(Rw_j).reshape(16, -1).max(1))


def test_slot_map_sel_roundtrip():
    slots = torch.tensor([[3, -1, 0, 7], [-1, -1, -1, -1], [1, 2, 5, 4]])
    sel = ciu.sel_from_slots(slots, 8)
    assert sel.shape == (3, 4, 8) and int(sel.sum()) == 7
    assert torch.equal(ciu.slots_from_sel(sel), slots)
    assert torch.equal(ciu.slots_from_sel(sel.float()), slots)


@pytest.mark.parametrize("k_hi", [12, 16, 32])
def test_slot_capacities_match_jax_engine(k_hi, monkeypatch):
    """m = 48, 64 and 128: the port's (s_max, s2) equal the JAX engine's
    ``ciu_s_max`` / ``_ciu_s2`` where its compact Pallas kernel is live."""
    monkeypatch.setenv("LINEARMPC_TPU_CIUPALLAS", "interpret")
    mpc = _mpc(k_hi)
    mpc.setup(dtype=jnp.float32)
    e = mpc.engine
    assert e.use_ciu_batch and e.use_ciu_pallas
    n_eq = int(np.sum(np.asarray(e.ldp.is_eq)))
    assert ciu.slot_capacities(e.ldp.m, e.ldp.n, n_eq) == (e.ciu_s_max, e._ciu_s2)


@pytest.mark.parametrize("m,s", [(48, 16), (128, 16), (256, 24), (448, 24), (640, 24)])
def test_ciu_max_chunk_lanes_matches_jax(m, s):
    assert ciu.ciu_max_chunk_lanes(m, s) == P.ciu_max_chunk_lanes(m, s)


def test_phase1_ciu_takes_one_entry_inverse():
    """phase1_ciu and its plain version take one (s, s) entry inverse for
    every lane and give what the expanded batch gives."""
    e = _problem()
    m, s = e.ldp.m, 16
    arr = e.arrays
    th = jnp.asarray(_thetas(8.0, 7), jnp.float32)
    du = torch.tensor(np.asarray(arr.du + th @ arr.Dth.T))
    dl = torch.tensor(np.asarray(arr.dl + th @ arr.Dth.T))
    G, Gs = iu.gram(e.ldp, torch.float32, "cpu")
    args = (G, Gs, du, dl, torch.tensor(np.asarray(arr.is_eq)),
            torch.tensor(np.asarray(arr.is_immutable)), torch.zeros(B, m),
            torch.zeros(B, m, dtype=torch.bool), torch.ones(B, m, dtype=torch.bool),
            torch.full((B, s), -1))
    kw = dict(max_iter=60, primal_tol=e.primal_tol, sign_tol=e.sign_tol)
    one = ciu.phase1_ciu(*args, torch.eye(s), **kw)
    for a, b in zip(one, ciu.phase1_ciu_plain(*args, torch.eye(s).expand(B, s, s), **kw)):
        assert torch.equal(a, b)
