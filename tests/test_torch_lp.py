"""The port's batched interior-point LP oracle (``linearmpc_tpu_torch/ops/
lp_ipm.py``) against the JAX package's (``linearmpc_tpu/ops/lp_ipm.py``)
and against HiGHS, on the CPU (``device="cpu"``), float64.

Parity is defined by objectives, gaps, radii and verdicts, never by the
iterates x or the centers: an optimal Chebyshev center is often not
unique. Tolerances: objective and gap 1e-9 relative (1 + |v|) on random
lanes, objective 1e-12 relative on the chunks the JAX package's invpend
enumeration solves, radius 1e-7 (the JAX package's HiGHS contract).
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu.ops.lp_ipm as jlp
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.explicit import _chebyshev_radius
from linearmpc_tpu_torch.ops import lp_ipm


def _oracle_lanes(B=64, m=24, nth=7, seed=0):
    """``tests/test_lp_oracle.py``'s generator: normalized random rows,
    mixed feasible and empty instances, box +-10."""
    rng = np.random.default_rng(seed)
    lb, ub = -10 * np.ones(nth), 10 * np.ones(nth)
    As = np.zeros((B, m, nth))
    bs = np.ones((B, m))
    for i in range(B):
        k = rng.integers(5, m)
        A = rng.standard_normal((k, nth))
        A /= np.linalg.norm(A, axis=1, keepdims=True)
        bs[i, :k] = A @ rng.uniform(-5, 5, nth) + rng.uniform(-0.5, 2.0, k)
        As[i, :k] = A
    return As, bs, lb, ub


def _boxed_random_lp(B=32, m=12, n=4, seed=4):
    """``test_lp_oracle.py::test_numpy_ipm_matches_jitted``'s instance: a
    random cone with box rows, random objectives, start 0."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n))
    b = np.abs(rng.normal(size=(B, m))) + 0.5
    box = np.concatenate([np.eye(n), -np.eye(n)])
    A = np.concatenate([A, np.broadcast_to(box, (B, 2 * n, n))], axis=1)
    b = np.concatenate([b, np.full((B, 2 * n), 5.0)], axis=1)
    return A, b, rng.normal(size=(B, n)), np.zeros((B, n))


def _chebyshev_lp():
    As, bs, lb, ub = _oracle_lanes()
    A, b, c, x0 = lp_ipm.chebyshev_lp(As[:, :24], bs[:, :24], lb, ub)
    return A, b, np.broadcast_to(c, (A.shape[0], c.shape[0])), x0


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


@pytest.mark.parametrize("make", [_chebyshev_lp, _boxed_random_lp], ids=["chebyshev", "boxed"])
def test_lp_ipm_batch_matches_numpy_twin(make):
    """obj and gap within 1e-9 relative of the JAX package's NumPy twin of
    the same iteration, 45 iterations."""
    A, b, c, x0 = make()
    _x, obj, gap, rd = lp_ipm.lp_ipm_batch(_t(A), _t(b), _t(c), _t(x0), n_iter=45)
    _xn, obj_n, gap_n, rd_n = jlp._ipm_numpy(A, b, c, x0, 45)
    assert obj.dtype == torch.float64 and obj.device.type == "cpu"
    assert _rel(obj.numpy(), obj_n) <= 1e-9
    assert _rel(gap.numpy(), gap_n) <= 1e-9
    assert _rel(rd.numpy(), rd_n) <= 1e-9


def test_lp_ipm_batch_refuses_float32():
    A, b, c, x0 = _boxed_random_lp(B=2)
    with pytest.raises(TypeError):
        lp_ipm.lp_ipm_batch(_t(A).float(), _t(b).float(), _t(c).float(), _t(x0).float())


def test_lp_ipm_on_recorded_enumeration_chunks(monkeypatch):
    """Every chunk the JAX package's invpend enumeration solves, recorded
    at its ``_run_ipm``, through the port's IPM: objectives within 1e-12
    relative of the NumPy twin's."""
    chunks = []
    run = jlp._run_ipm

    def record(A, b, cs, x0, n_iter):
        chunks.append((np.array(A), np.array(b), np.array(cs), np.array(x0), n_iter))
        return run(A, b, cs, x0, n_iter)

    monkeypatch.setattr(jlp, "_run_ipm", record)
    mpc, prange = lmpc.mpc_examples("invpend")
    mpc.setup()
    lmpc.build_explicit(mpc, prange=prange)
    assert len(chunks) >= 5
    for A, b, cs, x0, n_iter in chunks:
        cs = np.broadcast_to(cs, (A.shape[0], A.shape[2]))
        _x, obj, _g, _rd = lp_ipm.lp_ipm_batch(_t(A), _t(b), _t(cs), _t(x0), n_iter=n_iter)
        _xn, obj_n, _gn, _rdn = jlp._ipm_numpy(A, b, cs, x0, n_iter)
        assert _rel(obj.numpy(), obj_n) <= 1e-12


def test_chebyshev_batch_matches_jax_and_highs():
    """The same emptiness verdict as the JAX package on every lane, r
    within 1e-7 of it, and within 1e-7 of HiGHS on every converged lane."""
    As, bs, lb, ub = _oracle_lanes()
    stats = {}
    r, c, gap = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu", stats=stats)
    r_j, _c_j, _gap_j = jlp.chebyshev_batch(As, bs, lb, ub)
    assert stats == {"ipm_chunks": 1, "ipm_lanes": 64}
    assert np.array_equal(r > 0, r_j > 0)
    assert np.max(np.abs(r - r_j)) <= 1e-7
    assert np.all(np.isfinite(gap))
    n_conv = 0
    for i in range(len(r)):
        if gap[i] > 1e-9:
            continue
        A = As[i][np.abs(As[i]).sum(1) > 0]
        r_ref, _c = _chebyshev_radius(A, bs[i][: len(A)], lb, ub)
        if r_ref == -np.inf:
            assert r[i] < 1e-7, i
        else:
            assert abs(r[i] - r_ref) < 1e-7, (i, r[i], r_ref)
            assert np.max(A @ c[i] - bs[i][: len(A)]) <= -r_ref + 1e-6
        n_conv += 1
    assert n_conv >= 60


def test_chunks_cut_to_rows_and_lanes(monkeypatch):
    """Lanes are sorted by their row count into chunks of at most
    ``LP_CHUNK`` lanes, each cut to its rows (at least 32): the radii do
    not depend on the chunking."""
    As, bs, lb, ub = _oracle_lanes(B=40, m=48, seed=2)
    As[:20, 24:] = 0.0
    bs[:20, 24:] = 1.0
    full = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu")[0]
    used = (np.linalg.norm(As, axis=2) > 1e-12).sum(1)
    chunks = list(lp_ipm._row_sorted_chunks(As))
    assert [len(i) for i, _m in chunks] == [40] and chunks[0][1] == used.max() > 32
    monkeypatch.setattr(lp_ipm, "LP_CHUNK", 16)
    stats = {}
    cut = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu", stats=stats)[0]
    assert stats == {"ipm_chunks": 3, "ipm_lanes": 40}
    chunks = list(lp_ipm._row_sorted_chunks(As))
    assert [m for _i, m in chunks] == [32, max(32, used[chunks[1][0]].max()), used.max()]
    assert np.max(np.abs(cut - full)) <= 1e-9


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["min", "max"])
def test_support_batch_matches_jax_and_is_certified(sign):
    """Support LPs min (sign e_i)'th over the invpend explicit regions from
    their Chebyshev centers, as ``build_tree`` poses them: values within
    1e-9 relative of the JAX package's, and the port's certified bound
    val - slack_tot never above HiGHS's optimum."""
    from scipy.optimize import linprog

    mpc, prange = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu")
    empc = tmpc.build_explicit(mpc, prange=prange)
    lb, ub = empc.lb, empc.ub
    regions = empc.regions[:48]
    mrow = max(len(cr.bth) for cr in regions)
    As = np.zeros((len(regions), mrow, empc.nth))
    bs = np.ones((len(regions), mrow))
    for k, cr in enumerate(regions):
        As[k, : len(cr.bth)], bs[k, : len(cr.bth)] = cr.Ath, cr.bth
    _r, cents, _g = lp_ipm.chebyshev_batch(As, bs, lb, ub, device="cpu")
    cs = sign * np.eye(empc.nth)[np.arange(len(regions)) % empc.nth]
    val, slack, gap = lp_ipm.support_batch(As, bs, lb, ub, cs, cents, device="cpu")
    val_j, slack_j, _gap_j = jlp.support_batch(As, bs, lb, ub, cs, cents)
    assert _rel(val, val_j) <= 1e-9
    assert np.all(slack >= 0) and np.all(np.isfinite(slack))
    for k, cr in enumerate(regions):
        res = linprog(cs[k], A_ub=cr.Ath, b_ub=cr.bth, bounds=list(zip(lb, ub)), method="highs")
        assert res.status == 0
        assert val[k] - slack[k] <= res.fun, (k, val[k] - slack[k], res.fun)


def test_oracle_defaults_to_the_card(monkeypatch):
    """With no device named the oracle runs on the card; without CUDA it
    raises (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    As, bs, lb, ub = _oracle_lanes(B=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lp_ipm.chebyshev_batch(As, bs, lb, ub)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lp_ipm.support_batch(As, bs, lb, ub, np.ones((2, 7)), np.zeros((2, 7)))
