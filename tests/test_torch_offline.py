"""The port's host-side offline modules against the JAX package's, on the
CPU: invariant sets (``invariant.py``), LP feasibility certificates
(``ops/lp_cert.py``), state-space models (``models/statespace.py``) and
checkpoints (``checkpoint.py``, files crossing between the packages both
ways). Polytopes are compared up to row order, within 1e-9.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu import invariant as jinv
from linearmpc_tpu.checkpoint import load_explicit as j_load_explicit
from linearmpc_tpu.checkpoint import load_problem as j_load_problem
from linearmpc_tpu.checkpoint import save_explicit as j_save_explicit
from linearmpc_tpu.checkpoint import save_problem as j_save_problem
from linearmpc_tpu.ops.lp_cert import certify_feasibility as j_certify_feasibility
from linearmpc_tpu_torch import invariant as tinv
from linearmpc_tpu_torch.ops.lp_cert import certify_feasibility

GOLDEN_U = 1.7612519326
X0 = [5.0, 5.0, 0.0, 0.0]

# tests/test_invariant.py's cases: (function, args, kwargs)
INVARIANT_CASES = {
    "bbm_10_12": ("invariant_set", (np.array([[0.5, 0.0], [1.0, -0.5]]), -10 * np.ones(2),
                                    10 * np.ones(2)),
                  dict(wmin=-np.ones(2), wmax=np.ones(2), eps_shrink=0.0)),
    "bbm_10_13": ("invariant_set", (np.array([[1.5, 0.0], [1.0, -1.5]]), -10 * np.ones(2),
                                    10 * np.ones(2)),
                  dict(G=np.array([[1.0], [0.0]]), umin=[-5.0], umax=[5.0],
                       wmin=-0.1 * np.ones(2), wmax=0.1 * np.ones(2), eps_shrink=0.0)),
    "autonomous": ("invariant_set", (np.array([[0.9, 0.2], [-0.1, 0.8]]), -np.ones(2),
                                     np.ones(2)), {}),
    "minrep": ("minrep", (np.array([[1.0, 0], [0, 1], [-1, 0], [0, -1], [1, 1]]),
                          np.array([1.0, 1, 1, 1, 5.0])), {}),
    "eliminate": ("eliminate", (np.vstack([np.eye(3), -np.eye(3)]), np.ones(6), [2]), {}),
}


def _rows(A, b):
    """Rows [A | b] in lexicographic order."""
    M = np.hstack([np.asarray(A), np.asarray(b).reshape(-1, 1)])
    return M[np.lexsort(M.T[::-1])]


@pytest.mark.parametrize("case", list(INVARIANT_CASES))
def test_polytopes_match_jax(case):
    fn, args, kw = INVARIANT_CASES[case]
    out_t = getattr(tinv, fn)(*args, **kw)
    out_j = getattr(jinv, fn)(*args, **kw)
    H, h = out_t[:2]
    H_j, h_j = out_j[:2]
    assert H.shape == H_j.shape and len(H) > 0
    assert np.max(np.abs(_rows(H, h) - _rows(H_j, h_j))) <= 1e-9
    if fn == "minrep":
        assert np.array_equal(out_t[2], out_j[2]) and len(h) == 4


def _box48(pkg):
    """invpend Np=50, Nc=8 with the +-18 state box on ks 2..11 (m = 48)."""
    mpc, _ = pkg.mpc_examples("invpend", 50, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    return mpc


def test_certify_feasibility_matches_jax():
    """The m = 48 problem at 48 points, x and r in +-12: the same verdict
    as the JAX package's on each, at least one infeasible point (which
    the port's float64 engine reports -3) and eight feasible ones."""
    mj, mt = _box48(lmpc), _box48(tmpc)
    mj.setup()
    mt.setup(device="cpu")
    assert mt.engine.ldp.m == 48
    rng = np.random.default_rng(3)
    ths = np.hstack([rng.uniform(-12, 12, (48, 6)), rng.uniform(-2, 2, (48, 1))])
    verdicts = [certify_feasibility(mt.engine.ldp, th) for th in ths]
    assert verdicts == [j_certify_feasibility(mj.engine.ldp, th) for th in ths]
    infeasible = [i for i, v in enumerate(verdicts) if v is False]
    assert infeasible and verdicts.count(True) >= 8
    assert mt.solve(ths[infeasible[0]])[2] == -3


@pytest.mark.parametrize("kind", ["continuous", "discrete", "tuple"])
def test_model_from_statespace_matches_jax(kind):
    """scipy.signal's continuous (ZOH at Ts = 0.1) and discrete systems and
    a plain tuple with a disturbance channel (``tests/test_explicit.py::
    test_model_from_statespace``): the same model in both packages."""
    if kind == "continuous":
        sys, kw = sig.StateSpace([[0.0, 1], [-2, -0.5]], [[0.0], [1]], [[1.0, 0]], [[0.0]]), {"Ts": 0.1}
    elif kind == "discrete":
        sys, kw = sig.StateSpace([[0.9]], [[1.0]], [[1.0]], [[0.0]], dt=0.2), {}
    else:
        sys, kw = (np.eye(2), np.ones((2, 3)), np.eye(2), np.zeros((2, 3))), {"Ts": 0.1, "nd": 1}
    m_t, m_j = tmpc.model_from_statespace(sys, **kw), lmpc.model_from_statespace(sys, **kw)
    assert (m_t.nx, m_t.nu, m_t.ny, m_t.nd, m_t.Ts) == (m_j.nx, m_j.nu, m_j.ny, m_j.nd, m_j.Ts)
    for name in ("F", "G", "Gd", "C", "Dd"):
        assert np.array_equal(getattr(m_t, name), getattr(m_j, name)), name


def test_statespace_refuses_feedthrough_and_missing_Ts():
    with pytest.raises(ValueError, match="feedthrough"):
        tmpc.model_from_statespace(([[1.0]], [[1.0]], [[1.0]], [[1.0]]), Ts=0.1)
    with pytest.raises(ValueError, match="Ts"):
        tmpc.model_from_statespace(([[1.0]], [[1.0]], [[1.0]], [[0.0]]))


def _golden_from_problem(loaded):
    qp, ldp, meta, K, engine = loaded
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu")
    theta = mpc.form_parameter(X0, uprev=[0.0])
    U, _fval, flag, _ = engine.solve(theta)
    assert flag == 1 and meta["nx"] == 4 and ldp.m == 5
    return U[0] - K @ theta[:4]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_problem_checkpoint_crosses_packages(tmp_path, writer):
    """A problem saved by either package loads in the port (and one the
    port saved in the JAX package), giving the golden u (1e-6)."""
    path = str(tmp_path / "invpend_problem.npz")
    if writer == "jax":
        mpc, _ = lmpc.mpc_examples("invpend")
        mpc.setup()
        j_save_problem(mpc, path)
    else:
        mpc, _ = tmpc.mpc_examples("invpend")
        mpc.setup(device="cpu")
        tmpc.save_problem(mpc, path)
        _qp, _ldp, _meta, K, engine = j_load_problem(path)
        theta = mpc.form_parameter(X0, uprev=[0.0])
        assert abs(engine.solve(theta)[0][0] - K @ theta[:4] - GOLDEN_U) < 1e-6
    loaded = tmpc.load_problem(path, device="cpu")
    assert loaded[4].device == torch.device("cpu")
    assert abs(_golden_from_problem(loaded) - GOLDEN_U) < 1e-6


@pytest.fixture(scope="module")
def explicit_pair():
    mj, rj = lmpc.mpc_examples("invpend")
    mj.setup()
    mt, rt = tmpc.mpc_examples("invpend")
    mt.setup(device="cpu")
    return lmpc.build_explicit(mj, prange=rj), tmpc.build_explicit(mt, prange=rt), mt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_explicit_checkpoint_crosses_packages(tmp_path, explicit_pair, writer):
    """An explicit controller saved by one package and loaded by the other
    gives the same u as the writer's on 32 sampled theta (1e-12) and the
    golden u; the port's loaded controller evaluates on its device."""
    e_j, e_t, mpc = explicit_pair
    path = str(tmp_path / "empc.npz")
    rng = np.random.default_rng(8)
    ths = np.hstack([rng.uniform(-15, 15, (32, 6)), rng.uniform(-2, 2, (32, 1))])
    ths[0] = mpc.form_parameter(X0, uprev=[0.0])
    if writer == "jax":
        j_save_explicit(e_j, path)
        src, dst = e_j, tmpc.load_explicit(path, device="cpu")
        assert dst.device == torch.device("cpu") and dst.mpc is None
        u_b, _viol = dst.evaluate_batch(ths)
        assert u_b.device.type == "cpu"
    else:
        tmpc.save_explicit(e_t, path)
        src, dst = e_t, j_load_explicit(path)
    assert len(dst.regions) == len(src.regions) == 93
    for th in ths:
        u_s, u_d = src.evaluate(th), dst.evaluate(th)
        assert (u_s is None) == (u_d is None)
        if u_s is not None:
            assert np.max(np.abs(u_s - u_d)) <= 1e-12
    assert abs(dst.evaluate(ths[0])[0] - GOLDEN_U) < 1e-6
