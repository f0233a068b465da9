"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without CUDA. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which sets JAX up.) Both
kernels are built without FMA contraction and sum in the plain versions'
order, so kernel and plain version agree bit for bit.
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu_torch as tmpc
from linearmpc_tpu_torch.ops import bulk, polish

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
