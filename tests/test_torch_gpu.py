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

Then every path at the shapes it runs at: the small-m, IU and compact
tiers' cold batches against the NumPy oracle, K3/K4 at the paths' own
shapes and on the launches the paths make, the three rollouts against the
CPU float64 rollout with each path's exact kernel launches, the hybrid
search's launch plan, syncs and starved budget rule, the closed-loop
satellite, the contact problem against the CPU float64 frontier and its
fixed-binary optimum, the single solves' launches, the float64 engine and
a non-symmetric H, the LP oracle and explicit MPC against HiGHS,
certification over invpend's whole range, the generated and explicit C
and the native runtime against the card, and mp-Schur at m = 1024.
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


def _box_mpc(k_hi, Np=50, device="cuda", dtype=torch.float32):
    """invpend Np/8 with the +-18 state box on ks 2..k_hi-1 (m = 48 at
    k_hi = 12, 128 at 32, 160 at 40), set up on ``device``."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend", Np, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),
                       ks=range(2, k_hi))
    return mpc.setup(device=device, dtype=dtype)


def _box_thetas(B, seed, box=12.0, device="cuda"):
    """x and r in +-box, u_prev in +-2."""
    rng = np.random.default_rng(seed)
    th = np.hstack([rng.uniform(-box, box, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    return torch.as_tensor(th, device=device)


def _box(k_hi, B, seed, Np=50, box=12.0):
    """The box problem's engine on the card and B thetas."""
    return _box_mpc(k_hi, Np).engine, _box_thetas(B, seed, box)


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


# -- the paths at their own shapes: tiers against the oracle, rollouts -------


def _oracle_check(ldp, th, U, status=None):
    """(max |U - U_oracle| over the lanes the NumPy oracle solves, lanes
    whose status contradicts the oracle's verdict of 1 or -3)."""
    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

    err, wrong = 0.0, 0
    for i, t in enumerate(th):
        U_ref, *_rest, s_ref = solve_ldp_numpy(ldp, t)
        if s_ref == 1:
            err = max(err, float(np.abs(U[i] - U_ref).max()))
        if status is not None and s_ref in (1, -3):
            wrong += int(status[i] != s_ref)
    return err, wrong


def _counts():
    """Every kernel's launch counter; the finish's gathers apart from its
    merges."""
    from linearmpc_tpu_torch.ops import iu_epilogue, roll_finish

    return dict(bulk=bulk.LAUNCHES, polish=polish.LAUNCHES, iu=iu.LAUNCHES, ciu=ciu.LAUNCHES,
                iu_epilogue=iu_epilogue.LAUNCHES,
                gather=roll_finish.LAUNCHES - roll_finish.MERGE_LAUNCHES,
                merge=roll_finish.MERGE_LAUNCHES)


def _launched(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _counts().items()}


@pytest.mark.parametrize("case", ["invpend", "invpend 50/10"])
def test_small_tier_cold_batch_matches_oracle(case):
    """The small-m tier's cold batch of 32,768 lanes over the example's
    range: U within 1e-9 of the oracle on the first 256 lanes the oracle
    solves; on invpend every lane status 1 with finite U, K1 and K2
    launched."""
    mpc, th = _small(SMALL_CASES[case], 32768, seed=2)
    eng = mpc.engine
    before = _counts()
    sol = eng.solve_batch(th)
    err, _ = _oracle_check(eng.ldp, th[:256].cpu().numpy(), sol.U[:256].cpu().numpy())
    assert err <= 1e-9
    if case == "invpend":
        n = _launched(before)
        assert n["bulk"] > 0 and n["polish"] > 0
        assert bool(torch.isfinite(sol.U).all()) and bool((sol.status == 1).all())


@pytest.mark.parametrize("entry", ["cold f32", "cold f64", "warm retry"])
@pytest.mark.parametrize("kind", ["iu", "ciu"])
def test_gi_kernel_at_the_paths_shape_matches_plain(kind, entry):
    """K3 at the IU path's m = 48 and K4 at the compact path's m = 128
    (invpend 50/8 with the +-18 box), B = 8192: cold in float32 from the
    tier's own carry (K4 capped at ``bulk_cap_p``), cold in float64 from
    the entry inverse (K4 at the guard's ``up8(2 s_max)`` slots), and warm
    from the float32 cold state with its carried inverse and the warm-ray
    retry, some lanes flagged from their warm start."""
    B = 8192
    eng, th = _box(12 if kind == "iu" else 32, B, seed=8, box=12.0 if kind == "iu" else 10.0)
    assert (eng.path, eng.ldp.m) == (("iu", 48) if kind == "iu" else ("compact", 128))
    dtype = torch.float64 if entry == "cold f64" else torch.float32
    args, kw = _gi_inputs(eng, th, dtype), _gi_kw(eng, dtype)
    hi = eng.arrays_hi
    if kind == "iu":
        fn, plain = iu.phase1_iu, iu.phase1_iu_plain
        carry = ((iu.init_R_batch(hi.G_solve, args[7]),) if dtype == torch.float64
                 else (eng.iu_R0_init(B),))
    else:
        fn, plain = ciu.phase1_ciu, ciu.phase1_ciu_plain
        if dtype == torch.float64:
            Rw0, sl0, _ = ciu.init_compact_batch(hi.G_solve, args[7], ciu.up8(2 * eng.ciu_s_max))
            carry = (sl0, Rw0)
        else:
            carry, kw = eng._ciu_cold_carry(B), dict(kw, max_iter=eng.bulk_cap_p)
    if entry == "warm retry":
        cold = fn(*args, *carry, **kw)
        args, kw = _warm(eng, cold, th, 9), _gi_kw(eng, torch.float32)
        carry = (cold[6],) if kind == "iu" else (cold[7], cold[8])
        assert bool(fn(*args, *carry, **kw)[5].any())  # the retry has lanes to reset
        kw = dict(kw, retry_infeas=True)
    _same(fn(*args, *carry, **kw), plain(*args, *carry, **kw))


@pytest.mark.parametrize("kind", ["iu", "compact"])
def test_largem_tier_at_the_paths_shape_matches_oracle(kind):
    """The IU tier (m = 48, x and r in +-12) and the compact tier (m = 128,
    in +-10) cold at B = 8192: K3 or K4 launched, finite U, no lane -1; on
    the first 128 (IU) or 96 (compact) lanes U within 1e-9 of the oracle
    where it solves, and no verdict of the oracle contradicted."""
    n = 128 if kind == "iu" else 96
    eng, th = _box(12 if kind == "iu" else 32, 8192, seed=9, box=12.0 if kind == "iu" else 10.0)
    assert eng.path == kind
    before = _counts()
    sol = eng.solve_batch(th)
    assert _launched(before)["iu" if kind == "iu" else "ciu"] > 0
    assert bool(torch.isfinite(sol.U).all()) and bool((sol.status != -1).all())
    err, wrong = _oracle_check(eng.ldp, th[:n].cpu().numpy(), sol.U[:n].cpu().numpy(),
                               sol.status[:n].cpu().numpy())
    assert err <= 1e-9 and wrong == 0


def test_compact_tier_lane_past_its_guards_ends_infeasible():
    """The lane of ``tests/data/compact_lane1929.npz`` alone on the card's
    compact tier (m = 128): its float64 guard and first ladder pass fail,
    the last through an overflowed inverse, and it ends -3 with finite
    controls, as the JAX package's guard returns it."""
    from pathlib import Path

    eng = _box_mpc(32).engine
    theta = np.load(Path(__file__).parent / "data" / "compact_lane1929.npz")["theta"]
    sol = eng.solve_batch(torch.as_tensor(theta[None], device="cuda"))
    assert int(sol.status[0]) == -3 and bool(torch.isfinite(sol.U).all())


@pytest.mark.parametrize("launch", ["K4 second chance", "K3 warm rollout step",
                                    "K4 warm rollout step"])
def test_gi_path_launch_matches_plain(launch):
    """K3/K4 launches the large-m paths make, recorded and replayed against
    the plain versions: the compact tier's second chance (its ``s2`` slots,
    warm, with the retry) in a cold batch of 8192, and the 11th warm step of
    a rollout from x0 in +-0.25, K3 at 4096 lanes and K4 at 2048; one launch
    a rollout step."""
    k3 = launch.startswith("K3")
    mod, name, plain = ((iu, "phase1_iu", iu.phase1_iu_plain) if k3
                        else (ciu, "phase1_ciu", ciu.phase1_ciu_plain))
    mpc = _box_mpc(12 if k3 else 32)
    eng = mpc.engine
    if launch == "K4 second chance":
        calls = _record(ciu, "phase1_ciu", lambda: eng.solve_batch(_box_thetas(8192, 10, 10.0)))
        a, k = next(c for c in calls if c[0][9].shape[1] == eng._ciu_s2
                    and c[1].get("retry_infeas"))
    else:
        B = 4096 if k3 else 2048
        x0s = np.random.default_rng(3).uniform(-0.25, 0.25, (B, 4))
        calls = _record(mod, name,
                        lambda: tmpc.build_rollout(mpc)(x0s, np.zeros((B, 2)), None, N=11))
        assert len(calls) == 11
        a, k = calls[10]
    _same(getattr(mod, name)(*a, **k), plain(*a, **k))


# each path's closed loop: problem, lanes, steps, x0 box, lanes held to the
# CPU float64 rollout, and its launches on the card
ROLLOUTS = {
    "small": (lambda d, t: tmpc.mpc_examples("invpend")[0].setup(device=d, dtype=t),
              4096, 500, 0.5, 8, lambda N: dict(bulk=2 * N, polish=2 * N, gather=N, merge=N)),
    "iu": (lambda d, t: _box_mpc(12, device=d, dtype=t), 4096, 500, 0.25, 8,
           lambda N: dict(iu=N, iu_epilogue=N)),
    "compact": (lambda d, t: _box_mpc(32, device=d, dtype=t), 2048, 300, 0.25, 0,
                lambda N: dict(ciu=N)),
}


@pytest.mark.parametrize("path", list(ROLLOUTS))
def test_rollout_on_card(path):
    """The float32 closed loop on the card from x0 in the box, r = 0: every
    step status 1 and finite values; the first lanes' controls within
    1e-5 (1 + |u|) of the CPU float64 rollout (state carried in float32 on
    the card); and exactly the path's launches: K1 and K2 twice a step (the
    float64 finish's again), one finish gather and merge a step (small m);
    K3 and the epilogue once a step (IU); K4 once a step (compact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, B, N, box, n_ref, launches = ROLLOUTS[path]
    mpc = make("cuda", torch.float32)
    assert mpc.engine.path == path
    x0s, rs = np.random.default_rng(6).uniform(-box, box, (B, 4)), np.zeros((B, 2))
    before = _counts()
    res = tmpc.build_rollout(mpc)(x0s, rs, None, N=N)
    assert _launched(before) == {**dict.fromkeys(before, 0), **launches(N)}
    assert bool((res.status == 1).all())
    assert all(bool(torch.isfinite(t).all()) for t in (res.xs, res.us, res.ys))
    if n_ref:
        ref = tmpc.build_rollout(make("cpu", torch.float64))(x0s[:n_ref], rs[:n_ref], None, N=N)
        us = res.us[:n_ref].double().cpu()
        assert ((us - ref.us).abs() / (1.0 + ref.us.abs())).max().item() <= 1e-5


# -- hybrid, lexicographic and contact paths ----------------------------------


def _binary_offset(mpc, U, lanes):
    """Largest distance of a binary control to its nearer finite bound over
    ``lanes`` and every binary move of the horizon."""
    nu = mpc.model.nu
    U = U[lanes].reshape(int(lanes.sum()), -1, nu)
    n_bin = U.shape[1] if mpc.Nc_binary < 0 else mpc.Nc_binary
    worst = 0.0
    for b in mpc.binary_controls:
        u = U[:, :n_bin, b]
        off = np.full(u.shape, np.inf)
        for bnd in (mpc.umin[b], mpc.umax[b]):
            if np.isfinite(bnd):
                off = np.minimum(off, np.abs(u - bnd))
        worst = max(worst, float(off.max()) if off.size else 0.0)
    return worst


def _sync_sites(fn):
    """file:line of each synchronizing call ``fn`` makes (the sync debug
    mode "warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def test_hybrid_search_on_card_at_its_batch():
    """The satellite through setup() (float32 on the card, m = 60, 40
    binary rows) at B = 512: one search entry launch on the 32-thread team
    and no step launch; no lane -1, and finite controls with every binary
    on a bound (1e-5) where an incumbent was found; no host sync in the
    entry's call; a launch of the round-by-round run enters with pending
    rows and branched equality rows; with the node limit starved to 24 on
    the first 64 lanes every lane ends 1 or 2, some 2, binaries on a bound,
    no status-1 lane off the unstarved optimum and no status-2 lane below
    it, by 1e-6 (1 + |f|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("satellite")
    eng = mpc.setup().engine
    assert eng.device.type == "cuda" and eng.dtype == torch.float32 and eng.bnb_mode == "inc"
    th = torch.as_tensor(np.random.default_rng(18).uniform(-1.0, 1.0, (512, eng.ldp.n_theta)),
                         device="cuda")
    before = iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES
    sol = eng.solve_batch(th)
    assert (iu.SEARCH_LAUNCHES, iu.STEP_LAUNCHES) == (before[0] + 1, before[1])
    assert sol.U.is_cuda and iu.last_plan("inc_search")["team"] == 32
    st, U = sol.status.cpu().numpy(), sol.U.double().cpu().numpy()
    found = (st == 1) | (st == 2)
    assert (st != -1).all() and np.isfinite(U[found]).all()
    assert _binary_offset(mpc, U, found) <= 1e-5
    fr = eng.inc_frontier()
    fr.search(th)
    assert _sync_sites(lambda: fr.search(th)) == []
    calls = _record(iu, "step_iu", lambda: _kernel_rounds(eng.inc_frontier(), th))
    n_eq = int(eng.ldp.is_eq.sum())
    assert any(int((a[6].pend >= 0).sum()) > 0 and int(a[4].sum(1).max()) > n_eq
               for a, _k in calls)
    fr_s = eng.inc_frontier()
    fr_s.node_limit = 24
    sol_s = fr_s.finish(fr_s.search(th[:64]))
    st_s, U_s = sol_s.status.cpu().numpy(), sol_s.U.double().cpu().numpy()
    assert ((st_s == 1) | (st_s == 2)).all() and (st_s == 2).any()
    assert _binary_offset(mpc, U_s, st_s > 0) <= 1e-5
    f_s, f_opt = sol_s.fval.double().cpu().numpy(), sol.fval[:64].double().cpu().numpy()
    tol = 1e-6 * (1.0 + np.abs(f_opt))
    assert not (np.abs(f_s - f_opt) > tol)[st_s == 1].any()
    assert not (f_s < f_opt - tol)[st_s == 2].any()


def test_closed_loop_satellite_on_card():
    """The satellite at Np = 20 with reference preview through setup(): 20
    steps of ``simulate_kw`` toward y0 = 0.5 from step 5 (the case of
    ``tests/test_hybrid.py``) on the card; y0 ends within 1e-3 of 0.5 and
    every binary control sits on a bound (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("satellite", 20)
    mpc.settings.reference_preview = True
    mpc.setup()
    assert mpc.engine.device.type == "cuda"
    N = 20
    rs = np.vstack([np.hstack([np.zeros((1, 5)), 0.5 * np.ones((1, N - 5))]), np.zeros((2, N))])
    F, G = np.asarray(mpc.model.F), np.asarray(mpc.model.G)
    sim = tmpc.simulate_kw(mpc, x0=np.zeros(3), N=N, r=rs,
                           dynamics=lambda x, u, d: F @ x + G @ np.atleast_1d(u))
    us = np.asarray(sim.us)
    for b in mpc.binary_controls:
        assert np.all(np.isclose(us[b], mpc.umin[b], atol=1e-5)
                      | np.isclose(us[b], mpc.umax[b], atol=1e-5))
    assert abs(float(sim.ys[0, -1]) - 0.5) < 1e-3


def test_lex_levels_k1_launches_match_plain():
    """The two-level lexicographic problem (m = 7) through setup() at
    B = 8192: U in float64 on the card, every lane status 1, the first 256
    lanes within 1e-9 of the CPU LexSolver, and each level's K1 float64
    launch replayed against ``phase1_plain``, entry for entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = _lex_bench(None).engine
    assert eng.device.type == "cuda" and eng.path == "lex" and eng.ldp.m <= bulk.MAX_M
    th = torch.as_tensor(np.random.default_rng(20).uniform(-2.0, 2.0, (8192, eng.ldp.n_theta)),
                         device="cuda")
    sols = []
    calls = _record(bulk, "phase1", lambda: sols.append(eng.solve_batch(th)))
    sol = sols[0]
    assert len(calls) == len(eng.lex.levels)
    assert sol.U.is_cuda and sol.U.dtype == torch.float64 and bool((sol.status == 1).all())
    ref = _lex_bench("cpu").engine.solve_batch(th[:256].cpu())
    assert (sol.U[:256].cpu() - ref.U).abs().max().item() <= 1e-9
    for a, k in calls:
        _k1_equal(a, k)


def test_contact_rounds_on_card_match_cpu_f64_frontier():
    """invpend_contact at Np = 4 (m = 88, 16 binary rows) through setup():
    the float32 frontier rounds on the card at B = 4 against the CPU
    float64 frontier (status 1 on the same lanes, fval within 1e-6 (1 +
    |f|)), no lane -1, finite controls and binaries on a bound (1e-5) where
    an incumbent was found; the float64 engine's Cholesky frontier on the
    card on the same lanes, statuses equal to the CPU's and fval within
    1e-6; and one host sync in a poll of the rounds mid-search at B = 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend_contact", 4, 4)
    eng = mpc.setup().engine
    assert eng.device.type == "cuda" and eng.dtype == torch.float32 and eng.bnb_mode == "rounds"
    th = np.random.default_rng(3).uniform(-0.3, 0.3, (16, eng.ldp.n_theta))
    sol = eng.solve_batch(torch.as_tensor(th[:4], device="cuda"))
    st, U = sol.status.cpu().numpy(), sol.U.double().cpu().numpy()
    found = (st == 1) | (st == 2)
    assert sol.U.is_cuda and (st != -1).all() and np.isfinite(U[found]).all()
    assert _binary_offset(mpc, U, found) <= 1e-5
    ref = tmpc.mpc_examples("invpend_contact", 4, 4)[0].setup(
        device="cpu", dtype=torch.float64).engine.solve_batch(th[:4])
    ok, f_ref = ref.status.numpy() == 1, ref.fval.numpy()
    rel = lambda f: (np.abs(f - f_ref) / (1.0 + np.abs(f_ref)))[ok]
    assert np.array_equal(st == 1, ok) and (rel(sol.fval.double().cpu().numpy()) <= 1e-6).all()
    e64 = tmpc.mpc_examples("invpend_contact", 4, 4)[0].setup(
        device="cuda", dtype=torch.float64).engine
    assert e64.bnb_mode == "frontier"
    sol64 = e64.solve_batch(torch.as_tensor(th[:4], device="cuda"))
    assert torch.equal(sol64.status.cpu(), ref.status)
    assert (rel(sol64.fval.cpu().numpy()) <= 1e-6).all()
    fr = eng._rounds
    held = [fr.init(torch.as_tensor(th, device="cuda"))]

    def rounds(n):
        for _ in range(n):
            held[0], active = fr.step(held[0])
        return active

    rounds(40)
    assert len(_sync_sites(lambda: bool(rounds(fr.POLL_EVERY)))) == 1


def test_contact_bench_shape_incumbents_at_their_fixed_binary_optimum():
    """The JAX bench's contact shape (Np = 6, m = 142) through setup() at
    B = 4, on the frontier rounds: every lane finds an incumbent, each
    within 1e-6 (1 + |f|) of the float64 optimum of its binaries (each
    binary row fixed on the bound its multipliers favour, the continuous
    QP re-solved by the NumPy oracle to status 1)."""
    import dataclasses

    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend_contact", 6, 6)
    eng = mpc.setup().engine
    assert eng.bnb_mode == "rounds"
    ldp = eng.ldp
    th = np.random.default_rng(7).uniform(-0.3, 0.3, (4, ldp.n_theta))
    sol = eng.solve_batch(torch.as_tensor(th, device="cuda"))
    st = sol.status.cpu().numpy()
    assert ((st == 1) | (st == 2)).all()
    b = np.asarray(ldp.is_binary)
    for t, lm, f in zip(th, sol.lam.cpu().numpy(), sol.fval.cpu().numpy()):
        dt, c = ldp.Dth @ t, ldp.G @ lm
        up = (np.where(ldp.up_finite, ldp.du + dt + c, np.inf)
              <= np.where(ldp.lo_finite, -(ldp.dl + dt) - c, np.inf))
        d = np.where(up, ldp.du, ldp.dl)
        fixed = dataclasses.replace(ldp, du=np.where(b, d, ldp.du), dl=np.where(b, d, ldp.dl),
                                    is_eq=np.asarray(ldp.is_eq) | b)
        U, *_rest, status = solve_ldp_numpy(fixed, t, max_iter=5000)
        assert status == 1
        f_np = 0.5 * U @ ldp.H @ U + (ldp.f + ldp.f_theta @ t) @ U
        assert abs(f - f_np) / (1.0 + abs(f_np)) <= 1e-6


# -- single solves and the engines that open new routes -----------------------


def _lp_infeasible(mpc, theta):
    """Whether no U meets bl + W theta <= [I; A] U <= bu + W theta (HiGHS on
    a zero objective)."""
    from scipy.optimize import linprog

    q = mpc.mpQP
    E = q.extended_A()
    up, lo = q.bu + q.W @ theta, q.bl + q.W @ theta
    fu, fl = np.isfinite(up), np.isfinite(lo)
    res = linprog(np.zeros(E.shape[1]), A_ub=np.vstack([E[fu], -E[fl]]),
                  b_ub=np.hstack([up[fu], -lo[fl]]), bounds=(None, None), method="highs")
    return res.status == 2


def test_single_solves_launch_only_their_kernels():
    """Single solves through setup() on the card: the golden u through
    ``solve_single`` (1e-6); an infeasible point of the m = 48 box (HiGHS
    finds no feasible U) reports -3 with finite controls; float32 at
    m = 11 (256 lanes, batched ``solve_single``) within 1e-9 of the oracle
    where it solves, no verdict contradicted; m = 0 at the closed form
    (1e-9), every lane status 1. In all: K1 twice (float32, float64), K3
    once, nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(23)
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup()
    box = _box_mpc(12)
    th_x = next(t for t in _box_thetas(64, 23).cpu().numpy() if _lp_infeasible(box, t))
    mpc11, _ = tmpc.mpc_examples("invpend", 50, 11)
    eng11 = mpc11.setup().engine
    assert eng11.path == "single"
    th11 = _box_thetas(256, 11, 20.0).cpu().numpy()
    di = tmpc.MPC.from_discrete([[1.0, 0.1], [0.0, 1.0]], [[0.0], [1.0]], C=np.eye(2), Np=5, Nc=3)
    di.set_objective(Q=[1.0, 1.0], R=[0.1])
    eng0 = di.setup(dtype=torch.float32).engine
    th0 = rng.uniform(-1.0, 1.0, (256, eng0.ldp.n_theta))
    before, u = _counts(), []
    k1 = _record(bulk, "phase1", lambda: u.append(mpc.compute_control([5.0, 5.0, 0.0, 0.0])))
    U_x, _f, st_x, _info = box.solve(th_x)
    sol11 = eng11.solve_batch(th11)
    sol0 = eng0.solve_batch(th0)
    assert _launched(before) == dict(bulk=2, polish=0, iu=1, ciu=0, iu_epilogue=0, gather=0,
                                     merge=0)
    assert abs(u[0][0] - 1.7612519326) <= 1e-6
    assert sorted(str(a[2].dtype) for a, _k in k1) == ["torch.float32", "torch.float64"]
    assert st_x == -3 and np.isfinite(U_x).all()
    err, wrong = _oracle_check(eng11.ldp, th11, sol11.U.cpu().numpy(), sol11.status.cpu().numpy())
    assert err <= 1e-9 and wrong == 0
    U0 = th0 @ eng0.ldp.Uth_off.T + eng0.ldp.u_off
    assert bool((sol0.status == 1).all()) and np.abs(sol0.U.cpu().numpy() - U0).max() <= 1e-9


@pytest.mark.parametrize("case", ["invpend", "m=48"])
def test_f64_engine_on_card_matches_oracle(case):
    """The float64 exact path on the card: invpend at B = 4096 (K1's float64
    instantiation launched) and the m = 48 box at B = 256 (torch ops, no
    K1): U in float64 on the card, no lane -1, and on the first 256 lanes U
    within 1e-9 of the oracle where it solves, no verdict contradicted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if case == "invpend":
        mpc, B = tmpc.mpc_examples("invpend")[0].setup(device="cuda", dtype=torch.float64), 4096
        th = _box_thetas(B, 64, 20.0)
    else:
        mpc, B = _box_mpc(12, dtype=torch.float64), 256
        th = _box_thetas(B, 48)
    eng = mpc.engine
    assert eng.path == "exact"
    before = bulk.LAUNCHES
    sol = eng.solve_batch(th)
    assert (bulk.LAUNCHES > before) == (eng.ldp.m <= bulk.MAX_M) == (case == "invpend")
    assert sol.U.is_cuda and sol.U.dtype == torch.float64 and bool((sol.status != -1).all())
    err, wrong = _oracle_check(eng.ldp, th[:256].cpu().numpy(), sol.U[:256].cpu().numpy(),
                               sol.status[:256].cpu().numpy())
    assert err <= 1e-9 and wrong == 0


def _game(binary, device, dtype):
    """Two players with their own objectives (a non-symmetric H), player
    0's control binary or not."""
    mpc = tmpc.MPC.from_discrete([[1.0, 0.1], [0, 1]], [[0.0, 0], [1, 1]], C=np.eye(2), Np=3)
    mpc.set_objective(uids=[0], Q=[1, 0], Rr=1e3 * np.eye(1))
    mpc.set_objective(uids=[1], Q=[0, 1], Rr=1e3 * np.eye(1))
    mpc.set_bounds(umin=[0.0, -1.0], umax=[1.0, 1.0])
    if binary:
        mpc.set_binary_controls([0])
    return mpc.setup(device=device, dtype=dtype)


@pytest.mark.parametrize("binary", [False, True])
def test_nonsymmetric_h_on_card_matches_cpu_f64(binary):
    """The game MPC in float32 on the card at B = 64, without its binary
    (the small-m tier: K1 and K2 launched) and with it (branch and bound),
    against the CPU float64 engine: statuses equal, U within 1e-9 (1e-7
    with the binary)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc = _game(binary, None, torch.float32)
    eng = mpc.engine
    rng = np.random.default_rng(23)
    th = np.stack([mpc.form_parameter(rng.uniform(-2, 2, 2), r=rng.uniform(-1, 1, 2))
                   for _ in range(64)])
    before = _counts()
    sol = eng.solve_batch(torch.as_tensor(th, device="cuda"))
    n = _launched(before)
    ref = _game(binary, "cpu", torch.float64).engine.solve_batch(th)
    assert torch.equal(sol.status.cpu(), ref.status)
    assert (sol.U.double().cpu() - ref.U).abs().max().item() <= (1e-7 if binary else 1e-9)
    if not binary:
        assert n["bulk"] > 0 and n["polish"] > 0


def test_aircraft_tier_full_range_on_card():
    """The small-m tier on aircraft (m = 6) over its whole parameter range
    at B = 32768: every lane it solves has finite controls."""
    mpc, th = _small(SMALL_CASES["aircraft"], 32768, seed=24)
    sol = mpc.engine.solve_batch(th)
    assert bool(torch.isfinite(sol.U[sol.status == 1]).all())


# -- the offline analyses on the card ------------------------------------------


def test_chebyshev_batch_on_card_matches_highs():
    """The float64 LP oracle on the card on 1024 Chebyshev lanes: at least
    90% converge (gap <= 1e-9), and there the radius is within 1e-7 of
    HiGHS's with the same sign; ``lp_ipm_batch`` makes no more host syncs
    at 45 iterations than at 1 (none inside its loop)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linearmpc_tpu_torch.explicit import _chebyshev_radius
    from linearmpc_tpu_torch.ops import lp_ipm

    As, bs, lb, ub = _oracle_lanes()
    r, _c, gap = lp_ipm.chebyshev_batch(As, bs, lb, ub)
    conv = np.where(gap <= 1e-9)[0]
    assert len(conv) >= 1024 * 9 // 10
    for i in conv:
        A = As[i][np.abs(As[i]).sum(1) > 0]
        r_h, _c_h = _chebyshev_radius(A, bs[i][: len(A)], lb, ub)  # -inf: empty
        assert (r[i] > 1e-7) == (r_h > 1e-7)
        if np.isfinite(r_h):
            assert abs(r[i] - r_h) <= 1e-7
    A, b, c, x0 = (torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device="cuda")
                   for a in lp_ipm.chebyshev_lp(As, bs, lb, ub))
    syncs = [len(_sync_sites(lambda n=n: lp_ipm.lp_ipm_batch(A, b, c, x0, n_iter=n)))
             for n in (1, 45)]
    assert syncs[0] == syncs[1]


def _explicit_thetas(mpc, prange, B, seed):
    """theta over the inner 75% of the range in x, r, d and p and the whole
    range of u_prev (``tests/test_explicit.py``'s draw)."""
    lo, hi = prange.lower(), prange.upper()
    nx, nr, nd, nuprev, _np = mpc.get_parameter_dims()
    scale = np.full(len(lo), 0.75)
    scale[nx + nr + nd: nx + nr + nd + nuprev] = 1.0
    rng = np.random.default_rng(seed)
    return (lo + hi) / 2 + scale * (hi - lo) / 2 * rng.uniform(-1.0, 1.0, (B, len(lo)))


@pytest.mark.parametrize("name,n_regions", [("invpend", 93), ("ballplate", 275)])
def test_explicit_on_card_matches_highs_and_implicit(name, n_regions):
    """Explicit MPC through setup() with the LP oracle on the card: the
    regions of the HiGHS enumeration, active set for active set; then
    ``evaluate_batch`` in float64 on the card at B = 32768: of the first
    256 lanes at least half inside a region, u within 1e-9 of host
    ``evaluate`` there, and within 1e-6 of the float64 implicit engine on
    the card on at least half."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, prange = tmpc.mpc_examples(name)
    mpc.setup()
    empc = tmpc.build_explicit(mpc, prange=prange)
    e_host = tmpc.build_explicit(mpc, prange=prange, oracle="host")
    assert empc.device.type == "cuda" and empc.stats["ipm_chunks"] > 0
    sets = sorted(cr.active_set for cr in empc.regions)
    assert len(sets) == n_regions and sets == sorted(cr.active_set for cr in e_host.regions)
    th = _explicit_thetas(mpc, prange, 32768, 6)
    th_dev = torch.as_tensor(th, device="cuda")
    u, viol = empc.evaluate_batch(th_dev)
    assert u.is_cuda and u.dtype == torch.float64 and u.shape == (32768, empc.nu)
    u, viol = u[:256].cpu().numpy(), viol[:256].cpu().numpy()
    inside = np.where(viol < 1e-8)[0]
    assert len(inside) >= 128
    for i in inside:
        assert np.max(np.abs(u[i] - empc.evaluate(th[i]))) <= 1e-9
    m64, _ = tmpc.mpc_examples(name)
    m64.setup(device="cuda", dtype=torch.float64)
    sol = m64.engine.solve_batch(th_dev[:256])
    u_imp = sol.U.cpu().numpy()[:, :m64.model.nu] - th[:256, :m64.model.nx] @ m64.K.T
    both = (viol < 1e-8) & (sol.status.cpu().numpy() == 1)
    assert both.sum() >= 128 and np.abs(u - u_imp)[both].max() <= 1e-6


def test_explicit_tree_and_checkpoint_on_card(tmp_path):
    """invpend's explicit controller built on the card's oracle: its BST at
    leaf size 3 descends exactly (``tests/test_explicit.py``'s check on 200
    points: each descent ends in a leaf holding a region that contains
    theta, whose law gives the scan's u within 1e-9, on more than 120
    points); ``save_explicit`` / ``load_explicit`` keep the card and u bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, prange = tmpc.mpc_examples("invpend")
    mpc.setup()
    empc = tmpc.build_explicit(mpc, prange=prange)
    empc.build_tree(leaf_size=3)
    A, b, kids, leaf_off, leaf_reg, depth, _root = empc.bst_arrays()
    rng = np.random.default_rng(11)
    n_checked = 0
    for _ in range(200):
        theta = np.concatenate([rng.uniform(-15, 15, 4), rng.uniform(-15, 15, 2),
                                rng.uniform(-2, 2, 1)])
        u_scan = empc.evaluate(theta)
        if u_scan is None:
            continue
        node = 0
        for _d in range(depth + 1):
            node = kids[node, 1] if A[node] @ theta - b[node] > 0 else kids[node, 0]
            if node < 0:
                break
        assert node < 0
        hit = [r for r in leaf_reg[leaf_off[-node - 1]:leaf_off[-node]]
               if np.max(empc.regions[r].Ath @ theta - empc.regions[r].bth,
                         initial=-np.inf) <= 1e-8]
        assert hit
        cr = empc.regions[hit[0]]
        assert np.allclose(cr.F[: empc.nu] @ theta + cr.g[: empc.nu], u_scan, atol=1e-9)
        n_checked += 1
    assert n_checked > 120
    path = str(tmp_path / "empc.npz")
    tmpc.save_explicit(empc, path)
    back = tmpc.load_explicit(path)
    th = torch.as_tensor(_explicit_thetas(mpc, prange, 256, 6), device="cuda")
    assert back.device.type == "cuda"
    assert torch.equal(back.evaluate_batch(th)[0], empc.evaluate_batch(th)[0])


def test_certify_full_range_on_card(monkeypatch):
    """Iteration certification of invpend over its whole default range with
    the LP oracle on the card: 8909 regions, worst case 14 iterations, not
    exhausted, and every IPM call counted as one chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from linearmpc_tpu_torch.ops import lp_ipm

    mpc, prange = tmpc.mpc_examples("invpend")
    mpc.setup()
    calls, ipm = [], lp_ipm.lp_ipm_batch
    monkeypatch.setattr(lp_ipm, "lp_ipm_batch", lambda *a, **k: calls.append(1) or ipm(*a, **k))
    res = tmpc.certify(mpc, prange=prange)
    assert not res.exhausted
    assert len(res.partition) == 8909 and res.max_iterations == 14
    assert len(calls) == res.stats["ipm_chunks"] > 0


# -- deployment, tooling and the mp-Schur solver at the bench's shape ----------


def test_generated_c_explicit_c_and_native_runtime_agree_with_card(tmp_path):
    """invpend through setup(): the generated C (gcc) gives the golden u with
    flag 1; the explicit controller's C agrees with ``evaluate_batch`` on
    the card on 256 states (1e-9); the native C++ runtime at B = 512 solves
    every lane and agrees with the card engine within 1e-9."""
    import ctypes
    import shutil
    import subprocess

    from linearmpc_tpu_torch.native_runtime import NativeBatchSolver

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc")
    mpc, prange = tmpc.mpc_examples("invpend")
    mpc.setup()
    ct = ctypes.c_double

    def control(cpath, theta):
        so = cpath[:-2] + ".so"
        subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", so, cpath, "-lm"], check=True)
        lib = ctypes.CDLL(so)
        out = []
        for t in theta:
            lib.mpc_set_uprev((ct * 1)(t[6]))
            u = (ct * 8)()
            out.append((lib.mpc_compute_control(u, (ct * 4)(*t[:4]), (ct * 2)(*t[4:6]), None),
                        u[0]))
        return out

    golden = mpc.form_parameter([5.0, 5.0, 0.0, 0.0], uprev=[0.0])[None]
    (flag, u), = control(tmpc.codegen_c(mpc, str(tmp_path / "c")), golden)
    assert flag == 1 and abs(u - 1.7612519326) <= 1e-6
    empc = tmpc.build_explicit(mpc, prange=prange)
    th = _explicit_thetas(mpc, prange, 256, 28)
    u_e = np.array([v for _f, v in control(tmpc.codegen_c_explicit(empc, str(tmp_path / "e")),
                                           th)])
    u_eval, _viol = empc.evaluate_batch(th)
    assert u_eval.is_cuda and np.abs(u_e - u_eval[:, 0].cpu().numpy()).max() <= 1e-9
    th512 = _small(SMALL_CASES["invpend"], 512, seed=281)[1].cpu().numpy()
    U_n, _it, st_n = NativeBatchSolver(mpc.engine.ldp, nu=mpc.model.nu).solve_batch(th512)
    sol = mpc.engine.solve_batch(torch.as_tensor(th512, device="cuda"))
    assert bool((st_n == 1).all()) and np.abs(U_n - sol.U.cpu().numpy()).max() <= 1e-9


def test_mp_schur_at_the_bench_shape_and_mesh_rules():
    """The mp-Schur solver on a 1 x 1 NCCL mesh at the JAX bench's shape
    (invpend 255/8 with the box on ks 2..255, m = 1024, float64, B = 256):
    the first 8 lanes the oracle solves are status 1 and within 1e-8.
    ``attach_mesh`` keeps a problem below its threshold (m = 48) on the
    single-device path and refuses a hybrid engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
    from linearmpc_tpu_torch.parallel import make_mesh

    mpc, _ = tmpc.mpc_examples("invpend", 255, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 256))
    eng = mpc.setup(dtype=torch.float64).engine
    assert eng.ldp.m == 1024
    mesh = make_mesh(1, 1)
    try:
        eng.attach_mesh(mesh, force=True)
        th = _box_thetas(256, 31, 5.0)
        sol = eng.solve_batch(th)
        assert sol.U.is_cuda
        U, th, n = sol.U.cpu().numpy(), th.cpu().numpy(), 0
        for i in range(256):
            U_r, *_rest, s = solve_ldp_numpy(eng.ldp, th[i])
            if s == 1:
                assert int(sol.status[i]) == 1 and np.abs(U[i] - U_r).max() <= 1e-8
                n += 1
                if n == 8:
                    break
        assert n == 8
        small = _box_mpc(12, dtype=torch.float64).engine
        assert small.attach_mesh(mesh)._mp_solver is None
        with pytest.raises(ValueError, match="hybrid"):
            tmpc.mpc_examples("satellite")[0].setup().engine.attach_mesh(mesh)
    finally:
        dist.destroy_process_group()
