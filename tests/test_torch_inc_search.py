"""The float32 incremental-frontier search of the port on the CPU: the
property K3's search entry (``csrc/inc_search.cu``, one launch for the
whole search, a warp a lane) rests on, and the entry's guards.

Every quantity of a round is per lane, so a lane's search does not depend
on the other lanes of its batch: the plain search (``IncFrontier.
search_plain``, the rounds, the entry's plain version) run over a batch and
over each lane alone at B = 1 must finish with equal statuses, equal final
working sets and fval within 1e-9 (1 + |f|) (the float64 polish of one
working set at B = 1 and inside a batch). With the node limit starved, the
two runs may stop at other nodes: then every lane ends 1 or 2 (never -1),
a status-1 lane's fval is within 1e-6 (1 + |f|) of the unstarved search's,
a status-2 lane's fval no lower than that optimum less 1e-6 (1 + |f|), and
lanes whose 1/2 status differs between the runs are counted, not failed.
The search against the JAX package's incremental frontier is
``tests/test_torch_hybrid.py::test_f32_engine_matches_jax_interpret_frontier``
(the engine's CPU route is ``search_plain``). The entry itself runs only on
the card (``tests/test_torch_gpu.py``); here its wrapper must refuse CPU
tensors and the CPU engine must never call it.
"""

import functools

import numpy as np
import pytest
import torch

import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch.ops import bnb_frontier, iu

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _engine(Np, node_limit=None):
    mpc, _ = tmpc.mpc_examples("satellite", Np, Np)
    if node_limit is not None:
        mpc.settings.solver_opts["bnb_node_limit"] = node_limit
    eng = mpc.setup(device="cpu", dtype=torch.float32).engine
    assert eng.path == "hybrid" and eng.bnb_mode == "inc"
    return eng


def _thetas(eng, B, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).uniform(-1.0, 1.0, (B, eng.ldp.n_theta)))


def _solve(eng, th):
    fr = eng.inc_frontier()
    res = fr.search_plain(th)
    return fr.finish(res), res


@functools.lru_cache(maxsize=None)
def _batch_and_lanes(Np, B, node_limit=None):
    """The plain search over the batch and over each lane alone."""
    eng = _engine(Np, node_limit)
    th = _thetas(eng, B)
    whole = _solve(eng, th)
    alone = [_solve(eng, th[i:i + 1]) for i in range(B)]
    return whole, alone


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


@pytest.mark.parametrize("Np,B", [(6, 16), (20, 4)])
def test_search_of_a_lane_does_not_depend_on_its_batch(Np, B):
    (sol, res), alone = _batch_and_lanes(Np, B)
    assert np.all(sol.status.numpy() == 1)
    for i, (sol_i, res_i) in enumerate(alone):
        assert int(sol_i.status[0]) == int(sol.status[i])
        f, f_i = float(sol.fval[i]), float(sol_i.fval[0])
        assert abs(f_i - f) / (1.0 + abs(f)) <= 1e-9
        act, act_i = res.inc_active[i], res_i.inc_active[0]
        assert torch.equal(act, act_i)
        assert torch.equal(res.inc_side[i] & act, res_i.inc_side[0] & act_i)


def test_starved_node_limit_lanes_hold_the_budget_rule():
    """Satellite Np = 20, B = 4, the node limit starved to 24 (the full
    search takes 49-96 nodes a lane): status 2 appears, and the batch and
    the lanes alone each hold the starved-case rule against the
    unstarved optimum."""
    (full, _r), _alone = _batch_and_lanes(20, 4)
    f_opt = full.fval.double().numpy()
    (sol, _res), alone = _batch_and_lanes(20, 4, node_limit=24)
    runs = {"batch": sol.status.numpy(), "alone": np.array([int(s.status[0]) for s, _ in alone])}
    fvals = {"batch": sol.fval.double().numpy(),
             "alone": np.array([float(s.fval[0]) for s, _ in alone])}
    for name, st in runs.items():
        assert set(st.tolist()) <= {1, 2}, (name, st)
        f = fvals[name]
        assert np.all(_rel(f, f_opt)[st == 1] <= 1e-6), name
        assert np.all((f - f_opt >= -1e-6 * (1.0 + np.abs(f_opt)))[st == 2]), name
    assert (runs["batch"] == 2).any()
    n_diff = int(np.sum(runs["batch"] != runs["alone"]))
    print(f"starved satellite Np=20: {n_diff} of 4 lanes end 1 in one run and 2 in the other")


def test_lane_sum_is_the_warp_order():
    """``lane_sum`` adds entries t, t + 32, ... into 32 partial sums, then
    folds them by a butterfly: the same value as that loop written out."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((3, 70)).astype(np.float32))
    out = []
    for b in range(3):
        part = [torch.tensor(0.0)] * 32
        for k in range(70):
            part[k % 32] = part[k % 32] + x[b, k]
        for o in (16, 8, 4, 2, 1):
            part = [part[t] + part[t ^ o] for t in range(32)]
        out.append(part[0])
    assert torch.equal(bnb_frontier.lane_sum(x), torch.stack(out))


def test_search_entry_refuses_cpu_tensors():
    eng = _engine(6)
    fr = eng.inc_frontier()
    th = _thetas(eng, 2)
    before = (iu.LAUNCHES, iu.SEARCH_LAUNCHES)
    with pytest.raises(ValueError, match="cuda"):
        fr.search(th)
    assert (iu.LAUNCHES, iu.SEARCH_LAUNCHES) == before


def test_cpu_engine_runs_the_rounds_not_the_entry(monkeypatch):
    eng = _engine(6)

    def refuse(*a, **k):
        raise AssertionError("the CPU engine launched the search entry")

    monkeypatch.setattr(iu, "search_iu", refuse)
    before = iu.SEARCH_LAUNCHES
    sol = eng.solve_batch(_thetas(eng, 3))
    assert np.all(sol.status.numpy() == 1)
    assert iu.SEARCH_LAUNCHES == before
