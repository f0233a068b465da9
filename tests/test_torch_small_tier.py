"""The small-m tier (K1, then K2) on invpend at its published defaults (Np =
50, Nc = 5, R = 0, Rr = 1, theta = [x; r; u_prev], m = 5), built as the
benchmark builds it (``mpcbench/configs/invpend.py``). On the CPU, through
the kernels' plain versions: the float32 closed loop step by step against
the benchmark's plain float64 reference (``mpcbench/reference.py``) within
the invpend-montecarlo cell's limits, and the tier's spans and counters
(``profiling.py``) in the rollout's warm step and in a cold batch. One
test, marked ``gpu``, holds K1 and K2 to their plain versions at the
cell's 2,097,152 lanes and runs the warm rollout step at that size.

The file imports no JAX; on a card:
``python -m pytest --noconftest -m gpu tests/test_torch_small_tier.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import linearmpc_tpu_torch as L
from linearmpc_tpu_torch import profiling as P
from linearmpc_tpu_torch.ops import bulk, polish
from linearmpc_tpu_torch.ops.engine import FIX_TOL, STRAGGLER_K
from mpcbench import check, harness
from mpcbench import reference as ref

BENCH = Path(__file__).resolve().parents[1] / "mpcbench"
CELL = json.loads((BENCH / "workloads" / "invpend-montecarlo.json").read_text())
SMALL = ["lmpc.small.k1", "lmpc.small.polish"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(device):
    """(plant, the port's float32 MPC on ``device``) of the benchmark's
    invpend configuration."""
    cfg = json.loads((BENCH / "configs" / "invpend.json").read_text())
    mod = harness.load_module(BENCH / "configs" / "invpend.py", "test_small_tier_invpend")
    plant = mod.plant(cfg)
    mpc = mod.program(L, cfg, plant).setup(device=device, dtype=torch.float32)
    assert mpc.engine.path == "small" and mpc.engine.ldp.m == 5
    return plant, mpc


@pytest.fixture(scope="module")
def invpend():
    return _program("cpu")


def _lanes(B, seed):
    """The cell's draws: x0 in +-1 on the four states, one r a lane in +-1
    on the two tracked outputs, in float32 as the benchmark draws them."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 4)).astype(np.float32),
            rng.uniform(-1, 1, (B, 2)).astype(np.float32))


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, P.spans(), P.counts()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_rollout_follows_the_reference(invpend, seed):
    """8 lanes x 20 steps: at every step the float32 control against the
    reference's float64 QP at theta_k = [x_k; r; u_{k-1}] (u_{-1} = 0) and
    the next state against the plant's step, within the cell's limits;
    every status 1, and the input's bound rows active on some steps."""
    plant, mpc = invpend
    B, N = 8, 20
    x0, r = _lanes(B, seed)
    res = L.build_rollout(mpc)(x0, r, None, N=N)
    assert res.us.dtype == torch.float32 and res.xs.shape == (B, N, 4)
    assert bool((res.status == 1).all())
    qp = ref.condense(plant)
    assert (qp.nx, qp.nr, qp.nu_prev) == (4, 2, 1)
    limits, active = CELL["check"]["limits"], 0
    for j in range(B):
        u_err, x_err, sizes, _ = check.judge_rollout(
            qp, plant, x0[j], res.xs[j].double().numpy(), res.us[j].double().numpy(),
            res.status[j].numpy(), range(N), r[j].astype(np.float64))
        assert u_err <= limits["u_err"] and x_err <= limits["x_err"], (j, u_err, x_err)
        active += sum(1 for s in sizes if s)
    assert active > 0


def test_rollout_small_spans_and_counters(invpend):
    """Under a profiler session each step's solve holds ``lmpc.small.k1``
    then ``lmpc.small.polish``; ``small.lanes`` sums to B x N and
    ``small.k1_iters`` to the iterations the rollout returned."""
    _, mpc = invpend
    B, N = 8, 6
    x0, r = _lanes(B, 3)
    res, spans, counts = _recorded(lambda: L.build_rollout(mpc)(x0, r, None, N=N))
    names = [s.name for s in spans]
    assert names.count("lmpc.small.k1") == names.count("lmpc.small.polish") == N
    assert "lmpc.small.stragglers" not in names
    solves = [i for i, s in enumerate(spans) if s.name == "lmpc.rollout.solve"]
    assert len(solves) == N
    for i in solves:
        kids = [s for s in spans if s.parent == i]
        assert [k.name for k in kids] == SMALL
        assert spans[i].start_ns <= kids[0].start_ns <= kids[0].end_ns <= kids[1].start_ns
        assert kids[1].end_ns <= spans[i].end_ns
    assert P.counted("small.lanes") == [B] * N and counts["small.lanes"] == B * N
    assert counts["small.k1_iters"] == int(res.iters.sum()) > 0
    assert "small.stragglers_fixed" not in counts


def test_tier_batch_spans_and_straggler_counter(invpend, monkeypatch):
    """A cold batch of 300 lanes over the example's range (x and r in +-20),
    K1 stopped at 5 iterations so that some lanes end on a wrong working
    set: ``solve_batch`` holds K1, the polish and the stragglers in order;
    the counters are B, K1's iterations and the lanes of the worst 256
    whose residual called for the float64 continuation."""
    _, mpc = invpend
    monkeypatch.setattr(mpc.engine, "bulk_cap", 5)
    seen = {"k1": [], "k2": []}
    phase1, pol = bulk.phase1, polish.polish

    def phase1_seen(*a, **k):
        out = phase1(*a, **k)
        seen["k1"].append(out)
        return out

    def polish_seen(*a, **k):
        out = pol(*a, **k)
        seen["k2"].append(out)
        return out

    monkeypatch.setattr(bulk, "phase1", phase1_seen)
    monkeypatch.setattr(polish, "polish", polish_seen)
    B = 300
    rng = np.random.default_rng(4)
    th = np.hstack([rng.uniform(-20, 20, (B, 6)), rng.uniform(-2, 2, (B, 1))])
    sol, spans, counts = _recorded(lambda: mpc.engine.solve_batch(th))
    assert [s.name for s in spans] == ["lmpc.engine.solve_batch", *SMALL, "lmpc.small.stragglers"]
    assert [s.parent for s in spans] == [-1, 0, 0, 0]
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end_ns <= b.start_ns
    k1 = seen["k1"][0]
    assert k1[0].dtype == torch.float32 and k1[0].shape == (B, 5)
    bad = seen["k2"][0][3]
    fixed = int((torch.topk(bad, STRAGGLER_K).values > FIX_TOL).sum())
    assert 0 < fixed < STRAGGLER_K
    assert counts == {"small.lanes": B, "small.k1_iters": int(k1[3].sum()),
                      "small.stragglers_fixed": fixed}
    assert bool((sol.status == 1).all())


def test_no_session_stores_nothing(invpend):
    """Without a profiler session the small-m batch and rollout add nothing
    to the store: it holds the last session's one span, and no count."""
    _, mpc = invpend
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("lmpc.test"):
            pass
    before = P.spans()
    x0, r = _lanes(4, 5)
    mpc.engine.solve_batch(np.hstack([x0, r, np.zeros((4, 1), np.float32)]))
    L.build_rollout(mpc)(x0, r, None, N=2)
    assert P.spans() == before
    assert P.counts() == {}


def _same_on(idx, out_k, out_p):
    for a, b in zip(out_k, out_p):
        assert torch.equal(a[idx], b), (a.dtype, a.shape)


@pytest.mark.gpu
def test_small_kernels_and_warm_step_at_cell_size():
    """invpend-montecarlo's 2,097,152 lanes: the cold batch's K1 and K2, and
    the warm rollout step's, each against its plain version on the first
    and last 2048 lanes (entry for entry); the warm step returns a finite
    U and a status of 1 or -1 on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, mpc = _program("cuda")
    e, B = mpc.engine, 2 ** 21
    x0, r = _lanes(B, 6)
    th = torch.as_tensor(np.hstack([x0, r, np.zeros((B, 1), np.float32)]), device="cuda")
    calls = {"k1": [], "k2": []}
    phase1, pol = bulk.phase1, polish.polish

    def rec(kind, fn):
        # copies of the outputs: the warm step's finish merges into them
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls[kind].append((a, k, [t.clone() for t in out]))
            return out
        return wrapped

    bulk.phase1, polish.polish = rec("k1", phase1), rec("k2", pol)
    try:
        sol = e.solve_batch(th)
        U, lam, act, side, iters, status = e.fused_rollout_solve(th, sol.lam.float(), sol.active,
                                                                 sol.side)
        torch.cuda.synchronize()
    finally:
        bulk.phase1, polish.polish = phase1, pol
    idx = torch.cat([torch.arange(2048), torch.arange(B - 2048, B)]).cuda()
    # the cold batch's stragglers and the warm step's float64 finish run K1
    # (and the finish K2) on their slots besides
    k1 = [c for c in calls["k1"] if c[0][2].shape[0] == B]
    k2 = [c for c in calls["k2"] if c[0][2].shape[0] == B]
    assert len(k1) == 2 and len(k2) == 2 and len(calls["k2"]) == 3
    for a, k, out in k1:
        sliced = [t[idx] if isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == B
                  else t for t in a]
        _same_on(idx, out, bulk.phase1_plain(*sliced, **k))
    for a, _k, out in k2:
        pd, t, ac, sd = a
        _same_on(idx, out, polish.polish_plain(pd, t[idx], ac[idx], sd[idx]))
    assert U.shape == (B, 5) and bool(torch.isfinite(U).all())
    assert bool(((status == 1) | (status == -1)).all())
    assert float((status == 1).double().mean()) > 0.99
