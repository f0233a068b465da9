"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without CUDA. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.) Every
kernel is built without FMA contraction and sums in its plain version's
order, so kernel and plain version agree bit for bit: K1/K2 at invpend
m = 5 and at every team size and table placement they branch on (m = 4,
5, 6, 8, 9, 10, equality rows), at ragged batch sizes, at the launches of
a warm rollout step and of the f64 stragglers, and with a non-finite
theta; K3 (``ops/iu.py``) at m = 48 and K4 (``ops/ciu.py``) at m = 64, cold
in float32 and float64 and warm with the warm-ray retry in float32, then
the two large-m tiers against the oracle. K3 and K4 are also held against
their plain versions at ragged batch sizes with one shared entry inverse,
with a per-lane ``eq``, and on their wide-team paths: K3 in float64 at
m = 160 (R in global memory) and K4 in float64 at s = 96 (the guard
ladder's capacity). K3's resumable entry (``iu.step_iu``) is held against
its plain step cold in both instantiations at ragged batches and on every
launch of an incremental-frontier run round by round; K3's search entry
(``iu.search_iu``, the whole float32 search in one launch) against its
plain version, those rounds, on every output of every lane (the satellite
at ragged batches and with its node limit starved, ``invpend_contact`` at
m = 61 with ray retries); the hybrid engine on the card against the CPU
float64 frontier, and the lexicographic hierarchy on K1's
float64 instantiation against the CPU ``LexSolver``. The offline analyses
run no kernel of their own: the float64 LP oracle on the card against its
CPU run, invpend's explicit enumeration on the card against the CPU's, and
batched point location on the card against host ``evaluate``.
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch.ops import bulk, ciu, iu, polish

pytestmark = pytest.mark.gpu


def _engine_and_thetas(B=4096, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    th = np.hstack([rng.uniform(-20, 20, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    return mpc, torch.as_tensor(th, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_phase1_kernel_matches_plain(dtype):
    mpc, th = _engine_and_thetas()
    eng = mpc.engine
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    th = th.to(dtype)
    B, m = th.shape[0], eng.ldp.m
    args = (arr.subset_inv, arr.G, arr.du + th @ arr.Dth.T, arr.dl + th @ arr.Dth.T,
            eng._eq, eng._immut, torch.zeros((B, m), dtype=dtype, device="cuda"),
            torch.zeros((B, m), dtype=torch.bool, device="cuda"),
            torch.ones((B, m), dtype=torch.bool, device="cuda"))
    kw = dict(max_iter=30, primal_tol=2e-5, sign_tol=1e-6)
    before = bulk.LAUNCHES
    out_k = bulk.phase1(*args, **kw)
    out_p = bulk.phase1_plain(*args, **kw)
    assert bulk.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


def test_polish_kernel_matches_plain():
    mpc, th = _engine_and_thetas(seed=1)
    eng = mpc.engine
    sol = eng.solve_batch(th)
    before = polish.LAUNCHES
    out_k = polish.polish(eng._pd, th, sol.active, sol.side)
    out_p = polish.polish_plain(eng._pd, th, sol.active, sol.side)
    assert polish.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


def test_cuda_tier_golden_and_oracle():
    """The golden value and oracle accuracy through setup(device="cuda")."""
    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

    mpc, th = _engine_and_thetas(B=512, seed=2)
    u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])
    assert abs(u[0] - 1.7612519326) < 1e-6
    sol = mpc.engine.solve_batch(th)
    assert torch.all(sol.status == 1)
    U, thn = sol.U.cpu().numpy(), th.cpu().numpy()
    for i in range(64):
        U_ref, *_rest = solve_ldp_numpy(mpc.engine.ldp, thn[i])
        assert np.max(np.abs(U[i] - U_ref)) <= 1e-9


def _largem(k_hi, B=256, seed=3):
    """invpend 30/8 with the +-18 state box on ks 2..k_hi-1 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    mpc.setup(device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    th = np.hstack([rng.uniform(-12, 12, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    return mpc, torch.as_tensor(th, device="cuda")


def _gi_inputs(eng, th, dtype):
    G, Gs = (eng._G32, eng._Gs32) if dtype == torch.float32 else (eng._G64, eng._Gs64)
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    th = th.to(dtype)
    B, m = th.shape[0], eng.ldp.m
    return (G, Gs, arr.du + th @ arr.Dth.T, arr.dl + th @ arr.Dth.T, eng._eq, eng._immut,
            torch.zeros((B, m), dtype=dtype, device="cuda"), arr.is_eq.expand(B, m),
            torch.ones((B, m), dtype=torch.bool, device="cuda"))


def _gi_kw(eng, dtype):
    if dtype == torch.float32:
        return dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
    return dict(max_iter=eng.bulk_cap + 24, primal_tol=1e-6, sign_tol=1e-11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_iu_kernel_matches_plain(dtype):
    mpc, th = _largem(12)
    eng = mpc.engine
    args = _gi_inputs(eng, th, dtype)
    m = eng.ldp.m
    R0 = torch.eye(m, dtype=dtype, device="cuda").expand(th.shape[0], m, m)
    before = iu.LAUNCHES
    out_k = iu.phase1_iu(*args, R0, **_gi_kw(eng, dtype))
    out_p = iu.phase1_iu_plain(*args, R0, **_gi_kw(eng, dtype))
    assert iu.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ciu_kernel_matches_plain(dtype):
    mpc, th = _largem(16)
    eng = mpc.engine
    args = _gi_inputs(eng, th, dtype)
    s = eng.ciu_s_max if dtype == torch.float32 else 2 * eng.ciu_s_max
    hi = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    Rw0, sl0, _ = ciu.init_compact_batch(hi.G_solve, args[7], s)
    before = ciu.LAUNCHES
    out_k = ciu.phase1_ciu(*args, sl0, Rw0, **_gi_kw(eng, dtype))
    out_p = ciu.phase1_ciu_plain(*args, sl0, Rw0, **_gi_kw(eng, dtype))
    assert ciu.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


def _warm(eng, out, th, seed):
    """The f32 state ``out`` (lam, act, side) of a batch entering nearby
    thetas, as a rollout step enters K3/K4."""
    rng = np.random.default_rng(seed)
    th_next = th + torch.as_tensor(rng.normal(0.0, 0.5, tuple(th.shape)), device="cuda")
    args = _gi_inputs(eng, th_next, torch.float32)
    return args[:6] + (out[0], out[1] | eng.arrays.is_eq, out[2])


def test_iu_kernel_warm_retry_matches_plain():
    """K3 from a warm state with a carried (non-identity) R and the warm-ray
    retry, against its plain version."""
    mpc, th = _largem(12, seed=5)
    eng = mpc.engine
    kw = _gi_kw(eng, torch.float32)
    m = eng.ldp.m
    R0 = torch.eye(m, device="cuda").expand(th.shape[0], m, m)
    cold = iu.phase1_iu(*_gi_inputs(eng, th, torch.float32), R0, **kw)
    args = _warm(eng, cold, th, 6)
    assert bool(iu.phase1_iu(*args, cold[6], **kw)[5].any())  # the retry has lanes to reset
    out_k = iu.phase1_iu(*args, cold[6], **kw, retry_infeas=True)
    out_p = iu.phase1_iu_plain(*args, cold[6], **kw, retry_infeas=True)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


def test_ciu_kernel_warm_retry_matches_plain():
    """K4 from a warm state with a carried slot map and Rw and the warm-ray
    retry, against its plain version."""
    mpc, th = _largem(16, seed=7)
    eng = mpc.engine
    kw = _gi_kw(eng, torch.float32)
    Rw0, sl0, _ = ciu.init_compact_batch(eng.arrays.G_solve,
                                         eng.arrays.is_eq.expand(th.shape[0], eng.ldp.m),
                                         eng.ciu_s_max)
    cold = ciu.phase1_ciu(*_gi_inputs(eng, th, torch.float32), sl0, Rw0, **kw)
    args = _warm(eng, cold, th, 8)
    assert bool(ciu.phase1_ciu(*args, cold[7], cold[8], **kw)[5].any())
    out_k = ciu.phase1_ciu(*args, cold[7], cold[8], **kw, retry_infeas=True)
    out_p = ciu.phase1_ciu_plain(*args, cold[7], cold[8], **kw, retry_infeas=True)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k_hi", [12, 16])
def test_largem_tier_on_card_matches_oracle(k_hi):
    """The IU (m = 48) and compact (m = 64) tiers through setup(device=
    "cuda"): every oracle-feasible lane optimal within 1e-9."""
    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

    mpc, th = _largem(k_hi, B=512, seed=4)
    launches = (iu.LAUNCHES, ciu.LAUNCHES)
    sol = mpc.engine.solve_batch(th)
    assert (iu.LAUNCHES, ciu.LAUNCHES) != launches
    U, st, thn = sol.U.cpu().numpy(), sol.status.cpu().numpy(), th.cpu().numpy()
    for i in range(64):
        U_ref, *_rest, s_ref = solve_ldp_numpy(mpc.engine.ldp, thn[i])
        if s_ref == 1:
            assert st[i] == 1 and np.max(np.abs(U[i] - U_ref)) <= 1e-9


def _same(out_k, out_p):
    """Kernel and plain outputs equal entry for entry (NaN where both are)."""
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            assert bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        else:
            assert torch.equal(a, b)


def _box(k_hi, B, seed, Np=50, box=12.0):
    """invpend Np/8 with the +-18 state box on ks 2..k_hi-1 on the card
    (m = 48 at k_hi = 12, 128 at 32, 160 at 40) and B thetas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend", Np, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    mpc.setup(device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    th = np.hstack([rng.uniform(-box, box, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    return mpc.engine, torch.as_tensor(th, device="cuda")


@pytest.mark.parametrize("B", [1, 17, 8193])
@pytest.mark.parametrize("kind", ["iu", "ciu"])
def test_gi_kernel_ragged_batch_matches_plain(kind, B):
    """K3 (m = 48) and K4 (m = 128, s = 16) cold in float32 from one shared
    (n, n) entry inverse, at a batch of one lane, one lane more than a
    block holds, and one more than 8192."""
    eng, th = _box(12 if kind == "iu" else 32, B, seed=B)
    args = _gi_inputs(eng, th, torch.float32)
    kw = _gi_kw(eng, torch.float32)
    if kind == "iu":
        R0 = torch.eye(eng.ldp.m, device="cuda")
        out_k = iu.phase1_iu(*args, R0, **kw)
        out_p = iu.phase1_iu_plain(*args, R0.expand(B, -1, -1), **kw)
    else:
        s = eng.ciu_s_max
        sl0 = torch.full((B, s), -1, dtype=torch.int64, device="cuda")
        Rw0 = torch.eye(s, device="cuda")
        out_k = ciu.phase1_ciu(*args, sl0, Rw0, **dict(kw, max_iter=eng.bulk_cap_p))
        out_p = ciu.phase1_ciu_plain(*args, sl0, Rw0.expand(B, -1, -1),
                                     **dict(kw, max_iter=eng.bulk_cap_p))
    _same(out_k, out_p)


@pytest.mark.parametrize("kind", ["iu", "ciu"])
def test_gi_kernel_per_lane_eq_matches_plain(kind):
    """A per-lane equality mask (B, m), as the branch-and-bound frontier
    passes one: every lane starts with its own equality rows active and its
    own entry inverse."""
    B = 1000
    eng, th = _box(12 if kind == "iu" else 32, B, seed=11)
    m = eng.ldp.m
    rng = np.random.default_rng(12)
    eq = torch.as_tensor(rng.uniform(size=(B, m)) < 0.05, device="cuda")
    args = list(_gi_inputs(eng, th, torch.float32))
    args[4], args[7] = eq, eq
    kw = _gi_kw(eng, torch.float32)
    if kind == "iu":
        R0 = iu.init_R_batch(eng.arrays.G_solve, eq)
        out_k = iu.phase1_iu(*args, R0, **kw)
        out_p = iu.phase1_iu_plain(*args, R0, **kw)
    else:
        Rw0, sl0, _ = ciu.init_compact_batch(eng.arrays.G_solve, eq, eng.ciu_s_max)
        out_k = ciu.phase1_ciu(*args, sl0, Rw0, **kw)
        out_p = ciu.phase1_ciu_plain(*args, sl0, Rw0, **kw)
    _same(out_k, out_p)


def test_iu_kernel_f64_global_inverse_matches_plain():
    """K3 in float64 at m = 160: R (200 KB a lane) lives in global memory and
    a 128-thread team runs each lane."""
    eng, th = _box(40, 64, seed=13, box=10.0)
    assert eng.ldp.m == 160
    args = _gi_inputs(eng, th, torch.float64)
    R0 = torch.eye(160, dtype=torch.float64, device="cuda")
    kw = _gi_kw(eng, torch.float64)
    _same(iu.phase1_iu(*args, R0, **kw), iu.phase1_iu_plain(*args, R0, **kw))


def test_ciu_kernel_f64_ladder_capacity_matches_plain():
    """K4 in float64 at the guard ladder's s = 96 (m = 128): a 128-thread
    team per lane, Rw in shared memory."""
    eng, th = _box(32, 64, seed=14, box=10.0)
    args = _gi_inputs(eng, th, torch.float64)
    Rw0, sl0, _ = ciu.init_compact_batch(eng.arrays_hi.G_solve, args[7], 96)
    kw = _gi_kw(eng, torch.float64)
    _same(ciu.phase1_ciu(*args, sl0, Rw0, **kw), ciu.phase1_ciu_plain(*args, sl0, Rw0, **kw))


def test_default_setup_lands_on_cuda_f32():
    """setup() with no device runs on the card in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend")
    u = mpc.setup().compute_control([5.0, 5.0, 0.0, 0.0])
    assert mpc.engine.device.type == "cuda" and mpc.engine.dtype == torch.float32
    assert abs(u[0] - 1.7612519326) < 1e-6


# K1 / K2 at every team size and table placement: (example, Np, Nc) -> m;
# K1's team is 4 threads at m = 4, 8 at m = 5-8, 16 at m = 9-10, its table
# in shared memory up to m = 6 in float32 (m = 5 in float64) and read
# through L2 above; K2's team follows max(m, n)
SMALL_CASES = {"invpend 50/4": ("invpend", 50, 4), "invpend": ("invpend", None, None),
               "aircraft": ("aircraft", None, None), "nonlinear (eq rows)": ("nonlinear", None, None),
               "invpend 50/8": ("invpend", 50, 8), "invpend 50/9": ("invpend", 50, 9),
               "invpend 50/10": ("invpend", 50, 10)}


def _small(case, B, seed):
    """The small-m engine of an example on the card and B thetas over its
    parameter range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, prange = tmpc.mpc_examples(*case)
    mpc.setup(device="cuda", dtype=torch.float32)
    assert mpc.engine.path == "small"
    lo, hi = prange.lower(), prange.upper()
    th = lo + (hi - lo) * np.random.default_rng(seed).uniform(0.0, 1.0, (B, len(lo)))
    return mpc, torch.as_tensor(th, device="cuda")


def _k1_args(eng, th, dtype):
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    th = th.to(dtype)
    B, m = th.shape[0], eng.ldp.m
    args = (arr.subset_inv, arr.G, arr.du + th @ arr.Dth.T, arr.dl + th @ arr.Dth.T,
            eng._eq, eng._immut, torch.zeros((B, m), dtype=dtype, device="cuda"),
            arr.is_eq.expand(B, m).contiguous(),
            torch.ones((B, m), dtype=torch.bool, device="cuda"))
    kw = (dict(max_iter=eng.bulk_cap, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)
          if dtype == torch.float32 else dict(max_iter=24, primal_tol=1e-6, sign_tol=1e-11))
    return args, kw


def _k1_equal(args, kw):
    before = bulk.LAUNCHES
    out_k = bulk.phase1(*args, **kw)
    out_p = bulk.phase1_plain(*args, **kw)
    assert bulk.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    return out_k


def _k2_equal(pd, th, act, side):
    before = polish.LAUNCHES
    out_k = polish.polish(pd, th, act, side)
    out_p = polish.polish_plain(pd, th, act, side)
    assert polish.LAUNCHES == before + 1
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


def _record(module, name, run):
    """The (args, kwargs) of every call of ``module.name`` while ``run()`` runs."""
    calls, orig = [], getattr(module, name)

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, rec)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(SMALL_CASES))
def test_small_kernels_team_sizes_match_plain(case, dtype):
    """K1 cold at 4097 lanes, then K2 on its working sets, equal entry for
    entry to their plain versions."""
    mpc, th = _small(SMALL_CASES[case], 4097, seed=21)
    eng = mpc.engine
    args, kw = _k1_args(eng, th, dtype)
    out = _k1_equal(args, kw)
    _k2_equal(eng._pd, th, out[1], out[2])


@pytest.mark.parametrize("B", [1, 17, 4097])
def test_small_kernels_ragged_batch_match_plain(B):
    """A batch of one lane, one lane more than a K2 block holds (16 at
    invpend) and one more than 4096."""
    mpc, th = _small(SMALL_CASES["invpend"], B, seed=B)
    eng = mpc.engine
    out = _k1_equal(*_k1_args(eng, th, torch.float32))
    _k2_equal(eng._pd, th, out[1], out[2])


def test_small_kernels_warm_rollout_step_match_plain():
    """The K1 and K2 launches of the 11th step of a 4096-lane rollout (each
    step's float64 finish launches both again on its 256 slots)."""
    mpc, _th = _small(SMALL_CASES["invpend"], 1, seed=0)
    x0s = np.random.default_rng(22).uniform(-0.5, 0.5, (4096, 4))
    run = lambda: tmpc.build_rollout(mpc)(x0s, np.zeros((4096, 2)), None, N=11)
    calls_p = []
    calls_b = _record(bulk, "phase1", lambda: calls_p.extend(_record(polish, "polish", run)))
    assert len(calls_b) == len(calls_p) == 22
    calls_b, calls_p = ([c for c in calls if c[0][2].shape[0] == 4096]
                        for calls in (calls_b, calls_p))
    assert len(calls_b) == len(calls_p) == 11
    args, kw = calls_b[10]
    _k1_equal(args, kw)
    _k2_equal(*calls_p[10][0])


def test_phase1_kernel_f64_stragglers_match_plain():
    """K1's float64 launch on the tier's 256 worst lanes (finish_from_state),
    recorded from a cold batch."""
    mpc, th = _small(SMALL_CASES["invpend"], 4096, seed=23)
    calls = _record(bulk, "phase1", lambda: mpc.engine.solve_batch(th))
    args, kw = next(c for c in calls if c[0][2].dtype == torch.float64)
    assert args[2].shape[0] == 256
    _k1_equal(args, kw)


def test_small_kernels_nonfinite_theta_lane_match_plain():
    """A lane whose theta holds a NaN and one holding an inf run on as the
    plain versions do (NaN where they give NaN), beside finite lanes."""
    mpc, th = _small(SMALL_CASES["invpend"], 64, seed=24)
    eng = mpc.engine
    th[3, 1] = float("nan")
    th[7, 0] = float("inf")
    args, kw = _k1_args(eng, th, torch.float32)
    out_k = bulk.phase1(*args, **kw)
    _same(out_k, bulk.phase1_plain(*args, **kw))
    _same(polish.polish(eng._pd, th, out_k[1], out_k[2]),
          polish.polish_plain(eng._pd, th, out_k[1], out_k[2]))


def test_small_rollout_step_makes_no_host_sync():
    """One warm step of the small-m rollout (K1 then K2) under the sync
    debug mode "error": no device-to-host copy or synchronize."""
    mpc, th = _small(SMALL_CASES["invpend"], 512, seed=25)
    eng = mpc.engine
    sol = eng.solve_batch(th)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng.fused_rollout_solve(th, sol.lam, sol.active, sol.side)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool((out[5] == 1).all())


# -- hybrid branch-and-bound and the lexicographic hierarchy on the card ------

def _satellite(B, seed, Np=None):
    """The satellite's float32 engine on the card (Np = Nc = 20 by default,
    m = 60, 40 binary rows) and B thetas in +-1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("satellite", *(() if Np is None else (Np, Np)))
    mpc.setup(device="cuda", dtype=torch.float32)
    eng = mpc.engine
    assert eng.path == "hybrid" and eng.bnb_mode == "inc"
    th = np.random.default_rng(seed).uniform(-1.0, 1.0, (B, eng.ldp.n_theta))
    return mpc, torch.as_tensor(th, device="cuda")


def _step_equal(args, kw):
    before = iu.STEP_LAUNCHES
    st_k, it_k = iu.step_iu(*args, **kw)
    st_p, it_p = iu.step_iu_plain(*args, **kw)
    assert iu.STEP_LAUNCHES == before + 1
    _same(tuple(st_k) + (it_k,), tuple(st_p) + (it_p,))
    return st_k


def _cold_step_args(eng, th, dtype, seed):
    """A K3 step from a cold state on node bounds with a random third of
    the binary rows clamped to one of their bounds (a per-lane eq)."""
    arr = eng.arrays if dtype == torch.float32 else eng.arrays_hi
    G, Gs = iu.gram(eng.ldp, dtype, "cuda")
    th = th.to(dtype)
    B, m = th.shape[0], eng.ldp.m
    du, dl = arr.du + th @ arr.Dth.T, arr.dl + th @ arr.Dth.T
    g = torch.Generator(device="cuda").manual_seed(seed)
    fixed = (arr.is_binary & arr.up_finite & arr.lo_finite) & (
        torch.rand((B, m), generator=g, device="cuda") < 0.33)
    d = torch.where(torch.rand((B, m), generator=g, device="cuda") < 0.5, du, dl)
    du, dl = torch.where(fixed, d, du), torch.where(fixed, d, dl)
    zb = torch.zeros((B, m), dtype=torch.bool, device="cuda")
    st = iu.IUState(torch.zeros((B, m), dtype=dtype, device="cuda"), zb, ~zb,
                    torch.full((B,), -1, device="cuda"),
                    torch.ones(B, dtype=torch.bool, device="cuda"),
                    torch.zeros(B, dtype=torch.int32, device="cuda"), zb[:, 0], zb[:, 0],
                    torch.eye(m, dtype=dtype, device="cuda"))
    args = (G, Gs, du.contiguous(), dl.contiguous(), arr.is_eq | fixed, arr.is_immutable, st)
    return args, dict(K=8, primal_tol=eng.primal_tol, sign_tol=eng.sign_tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 17, 512])
def test_step_kernel_cold_matches_plain(B, dtype):
    """K3's resumable entry from a cold state with a per-lane eq, in both
    instantiations and at ragged batches: then from the state it returned
    (lanes mid-search, some done), three more steps."""
    mpc, th = _satellite(B, seed=B)
    args, kw = _cold_step_args(mpc.engine, th, dtype, seed=B)
    st = _step_equal(args, kw)
    for _ in range(3):
        st = _step_equal(args[:-1] + (st,), kw)


def _kernel_rounds(fr, th):
    """The incremental frontier round by round on K3's step entry (the
    torch management between launches), as ``iu.SearchResult``."""
    s = fr.init(th)
    while fr.running(s):
        s = fr.round(s)
    return iu.SearchResult(*(getattr(s, f) for f in iu.SearchResult._fields))


def test_step_kernel_matches_plain_along_the_frontier():
    """Every K3 step launch of a 256-lane incremental frontier run round by
    round, each replayed against the plain step on its recorded inputs
    (pending rows, branched eq, idle lanes, root-snapshot restarts)."""
    mpc, th = _satellite(256, seed=31)
    eng = mpc.engine
    calls = _record(iu, "step_iu", lambda: _kernel_rounds(eng.inc_frontier(), th))
    assert len(calls) > 10
    n_pend = 0
    for args, kw in calls:
        _step_equal(args, kw)
        n_pend += int((args[-1].pend >= 0).sum())
    assert n_pend > 0


def test_hybrid_engine_on_card_matches_cpu_f64():
    """The satellite through setup() with no device: the incremental
    frontier in one launch of K3's search entry; statuses and fval (within 1e-6 (1 + |f|))
    against the CPU float64 frontier, no -1 lane, binaries on a bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("satellite")
    mpc.setup()
    eng = mpc.engine
    assert eng.device.type == "cuda" and eng.bnb_mode == "inc"
    th = np.random.default_rng(32).uniform(-1.0, 1.0, (48, eng.ldp.n_theta))
    before = (iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES)
    sol = eng.solve_batch(th)
    assert (iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES) == (before[0] + 1, before[1])
    ref_mpc, _ = tmpc.mpc_examples("satellite")
    ref = ref_mpc.setup(device="cpu").engine.solve_batch(th)
    st = sol.status.cpu()
    assert bool((st != -1).all()) and torch.equal(st == 1, ref.status == 1)
    ok = (st == 1).numpy()
    f, f_ref = sol.fval.cpu().numpy(), ref.fval.numpy()
    assert (np.abs(f - f_ref) / (1.0 + np.abs(f_ref)))[ok].max() <= 1e-6
    nu = mpc.model.nu
    U = sol.U.cpu().numpy().reshape(len(th), -1, nu)
    for b in mpc.binary_controls:
        lo, hi = mpc.umin[b], mpc.umax[b]
        off = np.minimum(np.abs(U[ok, :, b] - lo), np.abs(U[ok, :, b] - hi))
        assert off.max() <= 1e-5


def _contact(B, seed, Np=3):
    """``invpend_contact`` at Np = Nc = 3 (m = 61, the incremental frontier)
    on the card: nodes whose warm ray is retried cold, capped nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend_contact", Np, Np)
    mpc.setup(device="cuda", dtype=torch.float32)
    th = np.random.default_rng(seed).uniform(-0.3, 0.3, (B, mpc.engine.ldp.n_theta))
    return mpc, torch.as_tensor(th, device="cuda")


@pytest.mark.parametrize("case", ["satellite B=1", "satellite B=17", "satellite B=512",
                                  "satellite starved", "contact"])
def test_search_entry_matches_rounds(case):
    """K3's search entry (one launch for the whole search) against its
    plain version, the rounds of the plain step (``step_iu_plain``) and the
    torch management, which sum in the entry's order: every output of every
    lane equal, and the finished solutions too; then against the rounds on
    K3's step entry, which shares the entry's GI loop. The starved case
    stops the search at 24 nodes (status 2); the contact case retries warm
    rays cold and caps nodes."""
    if case == "contact":
        mpc, th = _contact(8, seed=3)
    else:
        B = 512 if case == "satellite starved" else int(case.split("=")[1])
        mpc, th = _satellite(B, seed=40 + B)
        if case == "satellite starved":
            mpc.engine.bnb_node_limit = 24
    eng = mpc.engine
    assert eng.bnb_mode == "inc"
    fr = eng.inc_frontier()
    before = iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES
    res_k = fr.search(th)
    assert (iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES) == (before[0] + 1, before[1])
    res_p = fr.search_plain(th)
    assert (iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    _same(tuple(res_k), tuple(res_p))
    _same(tuple(res_k), tuple(_kernel_rounds(fr, th)))
    sol_k, sol_p = fr.finish(res_k), fr.finish(res_p)
    _same(tuple(sol_k), tuple(sol_p))
    if case == "satellite starved":
        assert bool((sol_k.status == 2).any())
    if case == "contact":
        assert int(res_k.retries.sum()) > 0


def test_f32_hybrid_large_m_raises_on_card():
    """invpend_contact at Np = 4 (m = 88) is past the incremental frontier's
    routing rule: ``route`` sends a float32 engine to the frontier rounds on
    the card as on the CPU, and the card's engine takes them on the float64
    node arrays on the card."""
    from linearmpc_tpu_torch.ops.engine import route

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend_contact", 4, 4)
    mpc.setup(device="cuda", dtype=torch.float32)
    eng = mpc.engine
    assert route("cuda", torch.float32, eng.ldp.m, binaries=True) == ("hybrid", "rounds")
    assert eng.bnb_mode == "rounds" and eng._rounds.arr.G.is_cuda
    assert eng._rounds.arr.G.dtype == torch.float64


def test_f32_contact_engine_on_card_matches_cpu():
    """The float32 engine at m = 88 (the frontier rounds) on the card at
    B = 4 against the CPU float32 engine: statuses equal, fval within 1e-6
    (1 + |f|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend_contact", 4, 4)
    mpc.setup(device="cuda", dtype=torch.float32)
    eng = mpc.engine
    th = np.random.default_rng(3).uniform(-0.3, 0.3, (4, eng.ldp.n_theta))
    sol = eng.solve_batch(th)
    ref_mpc, _ = tmpc.mpc_examples("invpend_contact", 4, 4)
    ref = ref_mpc.setup(device="cpu", dtype=torch.float32).engine.solve_batch(th)
    assert torch.equal(sol.status.cpu(), ref.status) and bool((ref.status == 1).all())
    f, f_ref = sol.fval.cpu().numpy(), ref.fval.numpy()
    assert (np.abs(f - f_ref) / (1.0 + np.abs(f_ref))).max() <= 1e-6


def _box13(device, dtype):
    """invpend with the +-2 state box on ks 2..3 (m = 13)."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.add_constraint(Ax=np.eye(4), lb=-2 * np.ones(4), ub=2 * np.ones(4), ks=[2, 3])
    return mpc.setup(device=device, dtype=dtype)


def test_single_solve_reports_minus3_on_card():
    """A float32 single solve on the card goes through ``solve_single``: K3
    for the bulk phase (m = 13, beyond the subset cache), then the float64
    continuation; on infeasible points it returns -3 as on the CPU, with
    finite controls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng, ref = _box13("cuda", torch.float32).engine, _box13("cpu", torch.float32).engine
    rng = np.random.default_rng(1)
    th = np.hstack([rng.uniform(-20, 20, (2, 6)), rng.uniform(-2, 2, (2, 1))])
    for t in th:
        before = iu.LAUNCHES
        U, _f, status, _info = eng.solve(t)
        assert iu.LAUNCHES == before + 1
        assert status == -3 == ref.solve(t)[2] and np.isfinite(U).all()


@pytest.mark.parametrize("case", ["m=0", "m=11"])
def test_f32_single_path_on_card_matches_cpu(case):
    """float32 at m = 0 (the closed form) and at m = 11 (batched
    ``solve_single``, the masked subset-table loop as torch ops on the card
    and its float64 continuation) against the CPU engine: statuses equal,
    U within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def build(device):
        if case == "m=0":
            mpc = tmpc.MPC.from_discrete([[1.0, 0.1], [0.0, 1.0]], [[0.0], [1.0]], C=np.eye(2),
                                         Np=5, Nc=3)
            mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
        else:
            mpc, _ = tmpc.mpc_examples("invpend", 50, 11)
        return mpc.setup(device=device, dtype=torch.float32).engine

    eng, ref = build("cuda"), build("cpu")
    assert eng.path == "single" and eng.ldp.m == int(case[2:])
    rng = np.random.default_rng(5)
    th = (rng.uniform(-1, 1, (256, eng.ldp.n_theta)) if case == "m=0" else
          np.hstack([rng.uniform(-20, 20, (256, 6)), rng.uniform(-2, 2, (256, 1))]))
    sol, sol_ref = eng.solve_batch(th), ref.solve_batch(th)
    assert torch.equal(sol.status.cpu(), sol_ref.status) and bool((sol_ref.status == 1).all())
    assert (sol.U.cpu() - sol_ref.U).abs().max().item() <= 1e-9


@pytest.mark.parametrize("case", ["invpend", "m=48"])
def test_f64_engine_on_card_matches_cpu(case):
    """The float64 exact path on the card: invpend (m = 5) on K1's float64
    instantiation, and the m = 48 box problem (the masked Cholesky loop as
    torch ops) against the CPU engine: statuses equal, U within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def build(device):
        mpc, _ = tmpc.mpc_examples("invpend", *((50, 8) if case == "m=48" else (None, None)))
        if case == "m=48":
            mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                               ks=range(2, 12))
        return mpc.setup(device=device, dtype=torch.float64).engine

    eng, ref = build("cuda"), build("cpu")
    assert eng.path == "exact"
    box = 12.0 if case == "m=48" else 20.0
    rng = np.random.default_rng(6)
    th = np.hstack([rng.uniform(-box, box, (128, 6)), rng.uniform(-2, 2, (128, 1))])
    before = bulk.LAUNCHES
    sol, sol_ref = eng.solve_batch(th), ref.solve_batch(th)
    assert (bulk.LAUNCHES > before) == (case == "invpend")
    assert torch.equal(sol.status.cpu(), sol_ref.status)
    ok = (sol_ref.status == 1).numpy()
    assert ok.sum() >= 100
    assert (sol.U.cpu() - sol_ref.U).abs().numpy()[ok].max() <= 1e-9


def test_solve_single_kernel_launches_match_plain():
    """``solve_single``'s launches replayed against the plain versions, bit
    for bit: at m = 5 the K1 float32 bulk phase and the K1 float64
    continuation of a single solve; at m = 48 the K3 bulk phase of a batch
    of 64 (``bulk_inverse_updates``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend")
    eng = mpc.setup(device="cuda", dtype=torch.float32).engine
    th0 = mpc.form_parameter(np.array([5.0, 5.0, 0.0, 0.0]))
    calls = _record(bulk, "phase1", lambda: eng.solve(th0))
    assert sorted(str(a[2].dtype) for a, _k in calls) == ["torch.float32", "torch.float64"]
    for a, k in calls:
        _k1_equal(a, k)
    mpc48, _ = tmpc.mpc_examples("invpend", 50, 8)
    mpc48.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    eng48 = mpc48.setup(device="cuda", dtype=torch.float32).engine
    from linearmpc_tpu_torch.ops.dual_active_set import solve_single

    rng = np.random.default_rng(7)
    th = torch.as_tensor(np.hstack([rng.uniform(-12, 12, (64, 6)), rng.uniform(-2, 2, (64, 1))]),
                         device="cuda")
    calls = _record(iu, "phase1_iu", lambda: solve_single(eng48.arrays, th, **eng48._single_kw))
    assert len(calls) == 1
    a, k = calls[0]
    out_k, out_p = iu.phase1_iu(*a, **k), iu.phase1_iu_plain(*a, **k)
    for x, y in zip(out_k, out_p):
        assert torch.equal(x, y)


def _lex_bench(device, dtype=None):
    mpc = tmpc.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)
    mpc.set_bounds(umin=[-5.0], umax=[5.0])
    mpc.set_objective(Q=[1e-6], R=[1e-6])
    mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=0)
    mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=[2, 3], soft=True, prio=1)
    mpc.settings.hierarchy = "lexicographic"
    return mpc.setup(device=device, dtype=dtype)


def test_lex_on_card_runs_k1_f64_and_matches_cpu():
    """The two-level lexicographic bench problem (m = 7) on the card: each
    level on K1's float64 instantiation with the level's table; U within
    1e-9 of the CPU LexSolver, every lane status 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc = _lex_bench("cuda", torch.float32)
    eng = mpc.engine
    assert eng.path == "lex" and eng.ldp.m == 7
    th = np.random.default_rng(33).uniform(-2.0, 2.0, (2048, eng.ldp.n_theta))
    before = bulk.LAUNCHES
    sol = eng.solve_batch(th)
    assert bulk.LAUNCHES == before + len(eng.lex.levels)
    ref = _lex_bench("cpu").engine.solve_batch(th)
    assert bool((sol.status == 1).all())
    assert torch.equal(sol.status.cpu(), ref.status)
    assert (sol.U.cpu() - ref.U).abs().max().item() <= 1e-9


def test_lex_wide_on_card_matches_cpu():
    """A lexicographic problem past K1's table (Np = 5, m = 13): each level
    is the plain float64 masked Cholesky loop as torch ops on the card;
    statuses equal to the CPU LexSolver at B = 1024, U within 1e-8. Its
    weights (1e-6 against soft weights 1e6) put U's round-off floor near
    1e-9: a relative change of 1e-15 in theta moves U by 1.2e-9 on the CPU,
    and the CPU port and the JAX package differ by 1.6e-9 there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def build(device):
        mpc = tmpc.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=5, Nc=5)
        mpc.set_bounds(umin=[-5.0], umax=[5.0])
        mpc.set_objective(Q=[1e-6], R=[1e-6])
        mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=range(2, 6), soft=True, prio=0)
        mpc.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=range(2, 6), soft=True, prio=1)
        mpc.settings.hierarchy = "lexicographic"
        return mpc.setup(device=device).engine

    eng, ref = build("cuda"), build("cpu")
    assert eng.path == "lex" and eng.ldp.m == 13
    th = np.random.default_rng(34).uniform(-2.0, 2.0, (1024, eng.ldp.n_theta))
    before = bulk.LAUNCHES
    sol, sol_ref = eng.solve_batch(th), ref.solve_batch(th)
    assert bulk.LAUNCHES == before
    assert torch.equal(sol.status.cpu(), sol_ref.status) and bool((sol_ref.status == 1).all())
    assert (sol.U.cpu() - sol_ref.U).abs().max().item() <= 1e-8


def _oracle_lanes(B=1024, m=24, nth=7, seed=0):
    """``tests/test_lp_oracle.py``'s generator at 1024 lanes."""
    rng = np.random.default_rng(seed)
    As, bs = np.zeros((B, m, nth)), np.ones((B, m))
    for i in range(B):
        k = rng.integers(5, m)
        A = rng.standard_normal((k, nth))
        A /= np.linalg.norm(A, axis=1, keepdims=True)
        bs[i, :k] = A @ rng.uniform(-5, 5, nth) + rng.uniform(-0.5, 2.0, k)
        As[i, :k] = A
    return As, bs, -10 * np.ones(nth), 10 * np.ones(nth)


def test_chebyshev_batch_on_card_matches_cpu():
    """The float64 LP oracle on the card (no device named) against the
    same function on the CPU: the same verdict on every lane, radius and
    gap within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linearmpc_tpu_torch.ops import lp_ipm

    As, bs, lb, ub = _oracle_lanes()
    stats = {}
    r, _c, gap = lp_ipm.chebyshev_batch(As, bs, lb, ub, stats=stats)
    r_c, _c_c, gap_c = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu")
    assert stats == {"ipm_chunks": 1, "ipm_lanes": 1024}
    assert np.array_equal(r > 0, r_c > 0)
    assert np.max(np.abs(r - r_c)) <= 1e-9
    assert np.max(np.abs(gap - gap_c)) <= 1e-9


def _explicit_invpend(device):
    mpc, prange = tmpc.mpc_examples("invpend")
    mpc.setup(device=device)
    return tmpc.build_explicit(mpc, prange=prange)


def test_explicit_on_card_matches_cpu():
    """invpend's enumeration with the LP oracle on the card: the same 93
    active sets as on the CPU; the controller keeps the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e_d, e_c = _explicit_invpend("cuda"), _explicit_invpend("cpu")
    assert e_d.device.type == "cuda" and e_d.stats["ipm_chunks"] > 0
    sets = sorted(cr.active_set for cr in e_d.regions)
    assert sets == sorted(cr.active_set for cr in e_c.regions) and len(sets) == 93


def test_evaluate_batch_on_card_matches_host_evaluate():
    """Batched point location on the card (float64) against the host
    ``evaluate`` where the point lies in a region (1e-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    e_d = _explicit_invpend("cuda")
    rng = np.random.default_rng(6)
    th = np.hstack([rng.uniform(-15, 15, (4096, 6)), rng.uniform(-2, 2, (4096, 1))])
    u, viol = e_d.evaluate_batch(th)
    assert u.is_cuda and u.dtype == torch.float64
    u, viol = u.cpu().numpy(), viol.cpu().numpy()
    inside = np.where(viol < 1e-8)[0]
    assert len(inside) >= 3500
    for i in inside[:256]:
        assert np.max(np.abs(u[i] - e_d.evaluate(th[i]))) <= 1e-9


# -- deployment, tooling and the mp-Schur solver on the card --------------------


def test_export_replay_on_card_equals_direct_and_launches_kernels(tmp_path):
    """``export_compiled`` / ``load_compiled`` on the card at B = 256: the
    replay equals a direct ``solve_single`` call bit for bit and launches
    K1 (invpend) and K3 (the m = 48 box problem)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linearmpc_tpu_torch.ops.dual_active_set import solve_single

    box, _ = tmpc.mpc_examples("invpend", 50, 8)
    box.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    rng = np.random.default_rng(29)
    for mpc, counter in ((tmpc.mpc_examples("invpend")[0], bulk), (box, iu)):
        mpc.setup()
        eng = mpc.engine
        th = torch.as_tensor(np.hstack([rng.uniform(-12, 12, (256, 6)),
                                        rng.uniform(-2, 2, (256, 1))]), device="cuda")
        tmpc.export_compiled(mpc, str(tmp_path / "p.pt2"), batch=256)
        fn = tmpc.load_compiled(str(tmp_path / "p.pt2"))
        before = counter.LAUNCHES
        out = fn(th)
        torch.cuda.synchronize()
        assert counter.LAUNCHES > before
        direct = solve_single(eng.arrays, th, **eng._single_kw)
        for a, b in zip(out, (direct.U, direct.iters, direct.status)):
            assert a.is_cuda and torch.equal(a, b)


def test_codegen_c_agrees_with_card_engine(tmp_path):
    """The generated C for invpend (gcc) against the engine on the card on
    64 states: every flag 1, u within 1e-8."""
    import ctypes
    import shutil
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup()
    cpath = tmpc.codegen_c(mpc, str(tmp_path))
    so = str(tmp_path / "c.so")
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", so, cpath, "-lm"], check=True)
    lib = ctypes.CDLL(so)
    ct = ctypes.c_double
    rng = np.random.default_rng(28)
    th = np.hstack([rng.uniform(-15, 15, (64, 6)), rng.uniform(-2, 2, (64, 1))])
    sol = mpc.engine.solve_batch(torch.as_tensor(th, device="cuda"))
    for i, t in enumerate(th):
        lib.mpc_set_uprev((ct * 1)(t[6]))
        u = (ct * 1)()
        assert lib.mpc_compute_control(u, (ct * 4)(*t[:4]), (ct * 2)(*t[4:6]), None) == 1
        assert abs(u[0] - float(sol.U[i, 0])) <= 1e-8


def test_mp_schur_on_card_world_of_one():
    """The mp-Schur solver on a 1 x 1 mesh (NCCL, a world of one) for the
    m = 48 box problem in float64: the oracle's converged lanes within
    1e-8, through ``attach_mesh(force=True)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
    from linearmpc_tpu_torch.parallel import make_mesh

    mpc, _ = tmpc.mpc_examples("invpend", 30, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    eng = mpc.setup(dtype=torch.float64).engine
    mesh = make_mesh(1, 1)
    try:
        assert mesh.device_type == "cuda" and dist.get_backend() == "nccl"
        eng.attach_mesh(mesh, force=True)
        rng = np.random.default_rng(0)
        th = np.hstack([rng.uniform(-12, 12, (32, 6)), rng.uniform(-2, 2, (32, 1))])
        sol = eng.solve_batch(torch.as_tensor(th, device="cuda"))
        assert sol.U.is_cuda
        n = 0
        for i in range(32):
            U_r, *_rest, s = solve_ldp_numpy(eng.ldp, th[i])
            if s == 1:
                assert int(sol.status[i]) == 1
                assert np.max(np.abs(sol.U[i].cpu().numpy() - U_r)) <= 1e-8
                n += 1
        assert n >= 8
    finally:
        dist.destroy_process_group()
