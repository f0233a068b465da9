"""The float64 finish of the small-m warm rollout step
(``SolverEngine.fused_rollout_solve``), on the CPU through the plain
versions of K1, K2 and the finish's gather and merge: with K1 capped low so
that lanes fail the step's status rule, the finish turns them to status 1
at the float64 optimum, agrees with the cold tier's continuation
(``finish_from_state``) from the same state, leaves every lane that passed
as the step without it left it, bit for bit, and counts the lanes it took.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch import profiling as P
from linearmpc_tpu_torch.ops import bulk, engine as engine_mod, roll_finish
from linearmpc_tpu_torch.ops.dual_active_set import continue_from_state, finish_from_state
from linearmpc_tpu_torch.ops.engine import STRAGGLER_ITERS
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
from mpcbench import harness
from mpcbench.trace import Interval, Trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eng():
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float32)
    assert mpc.engine.path == "small"
    return mpc.engine


def _warm_step(eng, B=64, seed=5):
    """A cold batch over the example's range (x and r in +-20, u_prev in
    +-2), then the next step's theta: x moved by up to 2 and u_prev by up
    to 0.5, warm from the batch's state."""
    rng = np.random.default_rng(seed)
    th0 = np.hstack([rng.uniform(-20, 20, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    sol = eng.solve_batch(th0)
    th1 = th0 + np.hstack([rng.uniform(-2, 2, (B, 4)), np.zeros((B, 2)),
                           rng.uniform(-0.5, 0.5, (B, 1))])
    return torch.as_tensor(th1, dtype=torch.float32), (sol.lam.float(), sol.active, sol.side)


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _run(eng, th, warm, monkeypatch, finish):
    """The step's outputs, K1's float32 outputs and the session's counts."""
    k1 = []
    phase1 = bulk.phase1

    def seen(*a, **k):
        out = phase1(*a, **k)
        k1.append(out)
        return out

    with monkeypatch.context() as mp:
        mp.setattr(bulk, "phase1", seen)
        if not finish:
            mp.setattr(eng, "_roll_finish", lambda *a: None)
        with profile(activities=[ProfilerActivity.CPU]):
            out = eng.fused_rollout_solve(th, *warm)
        counts = P.counts()
    return out, k1[0], counts


@pytest.mark.parametrize("cap_k", [None, 4])
def test_finish_fixes_failed_lanes_only(eng, monkeypatch, cap_k):
    """K1 capped at one iteration on a warm step of 64 lanes. Without the
    finish some lanes end at -1; with it (all 64 slots, or 4 where the
    capacity is cut to 4) every lane taken ends at status 1 with U within
    1e-9 of the float64 oracle QP at its theta, and with the working set and
    iterations of ``finish_from_state`` from K1's float32 state; a lane not
    taken keeps the step's values bit for bit, -1 included; the counter
    ``small.roll_fixed`` is the number taken."""
    monkeypatch.setattr(eng, "bulk_cap", 1)
    if cap_k is not None:
        monkeypatch.setattr(engine_mod, "STRAGGLER_K", cap_k)
    th, warm = _warm_step(eng)
    base, k1_state, counts0 = _run(eng, th, warm, monkeypatch, finish=False)
    out, _k1, counts = _run(eng, th, warm, monkeypatch, finish=True)
    failed = base[5] != 1
    n_failed = int(failed.sum())
    assert n_failed > (cap_k or 0) and "small.roll_fixed" not in counts0
    took = failed & (out[5] == 1)
    n_took = n_failed if cap_k is None else cap_k
    assert int(took.sum()) == n_took == counts["small.roll_fixed"]
    # the merge adds the finish's iterations in place; the counter keeps K1's
    assert counts["small.k1_iters"] == int(k1_state[3].sum()) < int(out[4].sum())
    kept = ~took
    for b, o in zip(base, out):
        assert torch.equal(_bits(o[kept]), _bits(b[kept]))
    lane = torch.nonzero(took).squeeze(1)
    for i in lane.tolist():
        U_ref, *_rest = solve_ldp_numpy(eng.ldp, th[i].double().numpy())
        assert np.max(np.abs(out[0][i].numpy() - U_ref)) <= 1e-9, i
    lam32, act, side, iters, _done = k1_state
    ref = finish_from_state(eng.arrays_hi, th[lane], lam32[lane], act[lane], side[lane],
                            iters[lane], max_iter=STRAGGLER_ITERS, use_cholesky=eng.symmetric)
    assert torch.equal(out[2][lane], ref.active) and torch.equal(out[3][lane], ref.side)
    assert torch.equal(out[4][lane], ref.iters) and bool((ref.status == 1).all())
    assert float((out[0][lane] - ref.U).abs().max()) <= 1e-9


def test_finish_and_tier_share_one_continuation(eng):
    """The warm step's finish and the cold tier's stragglers continue in
    one function: ``finish_from_state`` is ``continue_from_state`` (its
    tolerances, bit for bit) with the primal recovery on top, so neither
    tier can drift from the other."""
    th, warm = _warm_step(eng, B=16, seed=7)
    lam, act, side = warm
    iters0 = torch.arange(16, dtype=torch.int32)
    th64 = th.double()
    cont = continue_from_state(eng.arrays_hi, th64, lam, act, side, iters0, max_iter=2)
    fin = finish_from_state(eng.arrays_hi, th64, lam, act, side, iters0, max_iter=2)
    for a, b in zip(cont, (fin.lam, fin.active, fin.side, fin.iters, fin.status == 1)):
        assert torch.equal(_bits(a), _bits(b))
    assert bool((cont.iters >= iters0).all()) and bool((cont.iters <= iters0 + 2).all())

def test_gather_and_merge_touch_only_taken_slots():
    """The plain gather and merge on 10 lanes and 4 slots, lanes 0 and 7
    failing: the gather takes them in lane order and fills the two spare
    slots from lane 0 again, not taken; the merge writes exactly the taken
    lanes, lane 0 as its taken slot has it,
    with the continuation's iterations and the status rule (done and
    residual within tol; a NaN residual fails)."""
    B, m, n, nth, K = 10, 3, 2, 4, 4
    g = torch.Generator().manual_seed(0)
    th = torch.randn(B, nth, dtype=torch.float64, generator=g)
    lam = torch.randn(B, m, generator=g)
    act, side = torch.rand(B, m, generator=g) > 0.5, torch.rand(B, m, generator=g) > 0.5
    iters = torch.arange(B, dtype=torch.int32)
    ok = torch.tensor([True] * B)
    ok[[0, 7]] = False
    idx, take, th_k, lam_k, act_k, side_k, iters_k = roll_finish.gather(ok, K, th, lam, act,
                                                                        side, iters)
    assert idx.tolist() == [0, 7, 0, 0] and take.tolist() == [True, True, False, False]
    assert torch.equal(th_k, th[idx]) and lam_k.dtype == torch.float64
    assert torch.equal(lam_k, lam[idx].double()) and torch.equal(iters_k, iters[idx])
    assert torch.equal(act_k, act[idx]) and torch.equal(side_k, side[idx])
    U, lam_p = torch.randn(B, n, dtype=torch.float64, generator=g), lam.double()
    status = torch.where(ok, 1, -1).to(torch.int32)
    before = [t.clone() for t in (U, lam_p, act, side, iters, status)]
    f64 = torch.float64
    fix = (torch.full((K, n), 9.0, dtype=f64), torch.full((K, m), 8.0, dtype=f64),
           torch.ones(K, m, dtype=torch.bool), torch.zeros(K, m, dtype=torch.bool),
           torch.tensor([3, 10, 5, 5], dtype=torch.int32), torch.tensor([True] * K),
           torch.tensor([0.0, float("nan"), 0.0, 0.0], dtype=f64))
    roll_finish.merge(idx, take, *fix, U, lam_p, act, side, iters, status, tol=1e-5)
    rest = torch.ones(B, dtype=torch.bool)
    rest[[0, 7]] = False
    for t, b in zip((U, lam_p, act, side, iters, status), before):
        assert torch.equal(t[rest], b[rest])
    assert U[0].tolist() == [9.0, 9.0] and lam_p[7].tolist() == [8.0] * m
    assert act[[0, 7]].all() and not side[[0, 7]].any()
    assert iters[[0, 7]].tolist() == [3, 10] and status[[0, 7]].tolist() == [1, -1]


def test_roll_fixed_reader_counts_lanes_a_step():
    """``roll_fixed_per_step.invpend`` is the counter over units x steps: 0
    where the finish took nothing, and silent without the counter (a program
    older than it) or without a device timeline (a run on the CPU)."""
    path = Path(__file__).resolve().parents[1] / "mpcbench" / "layers"
    read = harness.load_module(path / "roll_fixed_per_step.invpend.py",
                               "test_layer_roll_fixed").read

    def ctx(counts, device=True):
        tr = Trace()
        tr.device = [Interval("void k()", 0.0, 1e-6)] if device else []
        profiling = SimpleNamespace(counts=lambda: dict(counts))
        return SimpleNamespace(trace=tr, units=2, params={"steps": 250},
                               L=SimpleNamespace(profiling=profiling))

    assert read(ctx({"small.roll_fixed": 35, "small.lanes": 10})) == 35 / 500
    assert read(ctx({"small.roll_fixed": 0})) == 0.0
    assert read(ctx({"small.lanes": 10})) is None
    assert read(ctx({"small.roll_fixed": 35}, device=False)) is None


@pytest.mark.gpu
def test_finish_at_cell_size_on_card(monkeypatch):
    """invpend-montecarlo's 2,097,152 lanes on the card: a warm step makes
    no host sync with its finish, as it runs, and with K1 capped at one
    iteration so that far more than 256 lanes fail. There the 256 lanes
    taken agree with the cold tier's continuation (``finish_from_state``,
    K1's float64 launch) from the same state: working set, side and
    iterations equal, status 1 alike, U within 1e-9; every other lane keeps
    the step's values without the finish, bit for bit; the gather and merge
    kernels equal their plain versions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mpc, _ = tmpc.mpc_examples("invpend")
    e = mpc.setup(device="cuda", dtype=torch.float32).engine
    B = 2 ** 21
    g = torch.Generator(device="cuda").manual_seed(6)
    box = torch.tensor([1.0] * 6 + [0.0], device="cuda")
    th0 = (2 * torch.rand((B, 7), generator=g, device="cuda") - 1) * box
    sol = e.solve_batch(th0)
    warm = (sol.lam.float(), sol.active, sol.side)
    th = th0 + 0.1 * (2 * torch.rand((B, 7), generator=g, device="cuda") - 1) * box
    torch.cuda.synchronize()

    def step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return e.fused_rollout_solve(th, *warm)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    out = step()
    assert bool((out[5] == 1).all())

    monkeypatch.setattr(e, "bulk_cap", 1)
    with monkeypatch.context() as mp:
        mp.setattr(e, "_roll_finish", lambda *a: None)
        base = e.fused_rollout_solve(th, *warm)
    seen = {"k1": [], "gather": [], "merge": []}
    phase1, gather, merge = bulk.phase1, roll_finish.gather, roll_finish.merge

    def rec(kind, fn):
        # copies: the merge writes K1's outputs and its own arguments in place
        copy = lambda ts: [t.clone() if isinstance(t, torch.Tensor) else t for t in ts]

        def wrapped(*a, **k):
            seen[kind].append((copy(a), k))
            out = fn(*a, **k)
            seen[kind][-1] += (None if out is None else copy(out),)
            return out
        return wrapped

    monkeypatch.setattr(bulk, "phase1", rec("k1", phase1))
    monkeypatch.setattr(roll_finish, "gather", rec("gather", gather))
    monkeypatch.setattr(roll_finish, "merge", rec("merge", merge))
    out = step()
    torch.cuda.synchronize()
    (lam32, act, side, iters, _done) = seen["k1"][0][2]
    (g_args, _gk, g_out), = seen["gather"]
    idx, take = g_out[0], g_out[1]
    assert bool(take.all()) and int((base[5] != 1).sum()) > 256
    assert torch.equal(idx, torch.nonzero(base[5] != 1).squeeze(1)[:256])
    ref = finish_from_state(e.arrays_hi, th[idx], lam32[idx], act[idx], side[idx], iters[idx],
                            max_iter=STRAGGLER_ITERS, use_cholesky=e.symmetric)
    assert torch.equal(out[2][idx], ref.active) and torch.equal(out[3][idx], ref.side)
    assert torch.equal(out[4][idx], ref.iters)
    assert torch.equal(out[5][idx] == 1, ref.status == 1)
    assert float((ref.status == 1).double().mean()) > 0.99
    assert float((out[0][idx] - ref.U).abs().max()) <= 1e-9
    kept = torch.ones(B, dtype=torch.bool, device="cuda")
    kept[idx] = False
    for b, o in zip(base, out):
        assert torch.equal(_bits(o[kept]), _bits(b[kept]))
    for a, b in zip(g_out, roll_finish.gather_plain(*g_args)):
        assert torch.equal(_bits(a), _bits(b))
    (m_args, m_kw, _none), = seen["merge"]
    plain = [t.clone() for t in m_args]
    roll_finish.merge_plain(*plain, **m_kw)
    for a, b in zip(out, plain[9:15]):
        assert torch.equal(_bits(a), _bits(b))
