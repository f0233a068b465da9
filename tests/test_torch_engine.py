"""The port's solver engine on the CPU: the exact float64 path and the
float32 small-m tier (its kernels' plain versions), against the golden
value, the NumPy float64 oracle and the JAX engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch.ops import bulk, polish
from linearmpc_tpu_torch.ops.engine import SolverEngine, route
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

GOLDEN_U = 1.7612519326
DTYPES = [torch.float64, torch.float32]  # exact path, small-m tier


def _thetas(name, B, seed):
    """Uniform theta over the example's parameter range (for invpend x, r
    in +-20 and uprev in +-2, as bench.py:94-99)."""
    _, prange = lmpc.mpc_examples(name)
    lo, hi = prange.lower(), prange.upper()
    return lo + (hi - lo) * np.random.default_rng(seed).uniform(0.0, 1.0, (B, len(lo)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_golden_control(dtype):
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=dtype)
    u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])
    assert abs(u[0] - GOLDEN_U) < 1e-6


def test_golden_default_setup_is_exact_f64():
    """After setup(device="cpu"), a mutator's invalidate() and the implicit
    setup of the next solve stay on the CPU, on the exact float64 path."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu")
    mpc.invalidate()
    u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])  # setup() on first solve
    assert mpc.mpqp_issetup and mpc.engine.device.type == "cpu"
    assert mpc.engine.dtype == torch.float64 and not mpc.engine.tier
    assert abs(u[0] - GOLDEN_U) < 1e-6


def test_setup_without_device_needs_cuda(monkeypatch):
    """The entry points run on the card unless told otherwise: without CUDA,
    an explicit setup(), an implicit one and the engine raise and ask for
    device="cpu" instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mpc, _ = tmpc.mpc_examples("invpend")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mpc.setup()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mpc.compute_control([5.0, 5.0, 0.0, 0.0])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmpc.build_rollout(mpc)
    assert not mpc.mpqp_issetup
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SolverEngine(mpc.setup(device="cpu").engine.ldp)


def test_implicit_setup_reuses_explicit_dtype():
    """An implicit setup keeps the dtype of the last explicit one as well:
    the float32 small-m tier (its kernels' plain versions on the CPU)."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float32)
    mpc.set_objective(Q=[1.0, 1.0], R=[0.0], Rr=[1.0])  # a mutator: invalidates
    assert not mpc.mpqp_issetup
    res = tmpc.build_rollout(mpc)(np.zeros((2, 4)), np.zeros((2, 2)), None, N=3)
    assert mpc.engine.device.type == "cpu" and mpc.engine.dtype == torch.float32
    assert mpc.engine.path == "small" and res.us.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_controls_match_numpy_oracle(dtype):
    """Batched controls within 1e-9 of solve_ldp_numpy on 256 theta (the
    accuracy contract of the JAX package's bench headline)."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=dtype)
    thetas = _thetas("invpend", 256, 0)
    sol = mpc.engine.solve_batch(thetas)
    assert torch.all(sol.status == 1)
    U = sol.U.numpy()
    for i in range(len(thetas)):
        U_ref, _lam, _w, _it, status = solve_ldp_numpy(mpc.engine.ldp, thetas[i])
        assert status == 1
        assert np.max(np.abs(U[i] - U_ref)) <= 1e-9


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["invpend", "dcmotor", "aircraft", "nonlinear_demo"])
def test_status_codes_match_jax_engine(name, dtype):
    """Status codes equal to the JAX engine's (float64 on the CPU) on the
    same theta, for the four examples under the small-m gate. Controls of
    optimal lanes agree to round-off of U = ... - HinvET lam: soft rows
    drive |lam| to ~1e10 on aircraft lanes (both packages, and the NumPy
    oracle, differ there by ~4e-15 (1 + |lam|)), so 1e-13 (1 + max|lam|)."""
    mj, _ = lmpc.mpc_examples(name)
    mj.setup()
    mt, _ = tmpc.mpc_examples(name)
    mt.setup(device="cpu", dtype=dtype)
    assert mt.engine.ldp.m <= bulk.MAX_M
    thetas = _thetas(name, 64, 1)
    sol_j = mj.engine.solve_batch(jnp.asarray(thetas))
    sol_t = mt.engine.solve_batch(thetas)
    st_j = np.asarray(sol_j.status)
    assert np.array_equal(sol_t.status.numpy(), st_j)
    ok = st_j == 1
    dU = np.max(np.abs(sol_t.U.numpy() - np.asarray(sol_j.U)), axis=1)
    scale = 1.0 + np.max(np.abs(np.asarray(sol_j.lam)), axis=1)
    assert np.all(dU[ok] <= 1e-13 * scale[ok])


@pytest.mark.parametrize("dtype", DTYPES)
def test_invpend_unconstrained_matches_lstsq(dtype):
    """Mirrors tests/test_golden.py: with inactive constraints the QP
    solution is -H^-1 (f + f_theta theta)."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=dtype)
    qp = mpc.mpQP
    theta = mpc.form_parameter([0.01, 0.0, 0.0, 0.0])
    U_expected = -np.linalg.solve(qp.H, qp.f + qp.f_theta @ theta)
    U, fval, flag, info = mpc.solve(theta)
    assert flag == 1
    assert np.allclose(U, U_expected, atol=1e-9)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cold_vs_warm_start_equality(dtype):
    """Mirrors tests/test_rollout.py::test_cold_vs_warm_start_equality."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=dtype)
    rng = np.random.default_rng(21)
    thetas = np.hstack([rng.uniform(-10, 10, (32, 6)), rng.uniform(-2, 2, (32, 1))])
    cold = mpc.engine.solve_batch(thetas)
    thetas2 = thetas + rng.uniform(-0.05, 0.05, thetas.shape)
    warm = mpc.engine.solve_batch(thetas2, warm=(cold.lam, cold.active, cold.side))
    cold2 = mpc.engine.solve_batch(thetas2)
    assert torch.all(warm.status == 1)
    assert torch.max(torch.abs(warm.U - cold2.U)).item() < 1e-9
    assert warm.iters.double().mean() <= cold2.iters.double().mean()


def test_tier_on_cpu_runs_plain_versions_only():
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float32)
    before = (bulk.LAUNCHES, polish.LAUNCHES)
    mpc.engine.solve_batch(_thetas("invpend", 8, 2))
    assert (bulk.LAUNCHES, polish.LAUNCHES) == before


def test_tier_routes_stragglers_to_f64():
    """A straggler lane -- the bulk phase cut off after one iteration --
    comes back exact from the float64 continuation."""
    mpc, _ = tmpc.mpc_examples("invpend")
    mpc.setup(device="cpu", dtype=torch.float32)
    eng = mpc.engine
    thetas = _thetas("invpend", 16, 3)
    eng.bulk_cap = 1
    sol = eng.solve_batch(thetas)
    assert torch.all(sol.status == 1)
    for i in range(len(thetas)):
        U_ref, *_rest = solve_ldp_numpy(eng.ldp, thetas[i])
        assert np.max(np.abs(sol.U[i].numpy() - U_ref)) <= 1e-9


@pytest.mark.parametrize("case", [
    # the exact path, on K1's float64 instantiation on the card
    dict(dtype=torch.float64, name="invpend", route=("exact", None)),
    # m = 11: batched solve_single, the JAX engine's XLA fallback
    dict(dtype=torch.float32, name="invpend", Np=50, Nc=11, route=("single", None)),
    # binaries at m = 88: the frontier rounds (the satellite, m = 60, is "inc")
    dict(dtype=torch.float32, name="invpend_contact", Np=4, Nc=4,
         route=("hybrid", "rounds")),
])
def test_cuda_engine_outside_tier_raises(case):
    """The configurations that raised on CUDA before they were ported now
    route: ``route`` gives the same path on "cuda" as on "cpu", and the
    CPU engine takes it."""
    mpc, _ = tmpc.mpc_examples(case["name"], case.get("Np"), case.get("Nc"))
    mpc.setup(device="cpu", dtype=case["dtype"])
    eng, qp = mpc.engine, mpc.mpQP
    for dev in ("cuda", "cpu"):
        assert route(dev, case["dtype"], eng.ldp.m, symmetric=qp.is_symmetric,
                     binaries=qp.has_binaries) == case["route"]
    assert (eng.path, eng.bnb_mode) == case["route"]
    with pytest.raises(ValueError):
        route("mps", case["dtype"], eng.ldp.m)


@pytest.mark.parametrize("use_table", [True, False])
def test_polish_solution_matches_jax(use_table):
    """Direct f64 re-solve of known working sets (dual_active_set.py:811),
    through the subset table and through the masked Cholesky path."""
    import jax

    from linearmpc_tpu.ops import dual_active_set as jdas
    from linearmpc_tpu_torch.ops.dual_active_set import polish_solution, to_device_arrays

    mj, _ = lmpc.mpc_examples("invpend")
    mj.setup()
    thetas = _thetas("invpend", 32, 4)
    sol_j = mj.engine.solve_batch(jnp.asarray(thetas))
    arr_j = mj.engine.arrays if use_table else mj.engine.arrays._replace(subset_inv=None)
    pol_j = jax.vmap(lambda th, a, s: jdas.polish_solution(arr_j, th, a, s))(
        jnp.asarray(thetas), sol_j.active, sol_j.side)
    ldp = mj.engine.ldp
    arr_t = to_device_arrays(ldp, torch.float64, "cpu",
                             mj.engine._subset_inv if use_table else None)
    pol_t = polish_solution(arr_t, torch.as_tensor(thetas),
                            torch.tensor(np.asarray(sol_j.active)),
                            torch.tensor(np.asarray(sol_j.side)))
    assert np.max(np.abs(pol_t.U.numpy() - np.asarray(pol_j.U))) <= 1e-9
    f_j = np.asarray(pol_j.fval)  # |fval| reaches ~6e4: relative round-off
    assert np.all(np.abs(pol_t.fval.numpy() - f_j) <= 1e-12 * (1.0 + np.abs(f_j)))
