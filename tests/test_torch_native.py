"""The port's native CPU runtime (``linearmpc_tpu_torch/native_runtime.py``)
against the JAX package's and the port's engine. Both packages build the
same ``native/batch_solver.cpp``; their LDP arrays agree to round-off, so
their solutions agree within 1e-12. The port's library lands in its own
build directory, and ``native/build/`` is left as git has it."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import linearmpc_tpu as J
import linearmpc_tpu_torch as L
from linearmpc_tpu.native_runtime import NativeBatchSolver as JNative
from linearmpc_tpu_torch import native_runtime
from linearmpc_tpu_torch.native_runtime import NativeBatchSolver

ROOT = Path(__file__).resolve().parent.parent
needs_cxx = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("clang++") is None,
                               reason="no C++ compiler")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    many tiny torch ops on every core slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _invpend_thetas(seed, B):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-20, 20, (B, 4)), rng.uniform(-20, 20, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


@needs_cxx
def test_native_library_builds_in_port(tmp_path, monkeypatch):
    """The library is built from the repository's source, read only, into
    the port's build directory (here redirected to a temporary one); no file
    appears under ``native/``."""
    assert native_runtime.BUILD_DIR == ROOT / "linearmpc_tpu_torch" / "_build"
    src = (ROOT / "native" / "batch_solver.cpp").read_bytes()
    listing = sorted(p.name for p in (ROOT / "native").rglob("*"))
    monkeypatch.setattr(native_runtime, "BUILD_DIR", tmp_path / "b")
    lib = Path(native_runtime.build_native_library())
    assert lib.parent == tmp_path / "b" and lib.name.startswith("libbatchsolver_")
    assert native_runtime.build_native_library() == str(lib)  # keyed: no rebuild
    assert (ROOT / "native" / "batch_solver.cpp").read_bytes() == src
    assert sorted(p.name for p in (ROOT / "native").rglob("*")) == listing


@needs_cxx
def test_native_matches_jax_and_engine():
    """B = 512 invpend lanes: the port's runtime within 1e-12 of the JAX
    package's, within 1e-9 of the port's float64 engine, all status 1."""
    mpc_p = L.mpc_examples("invpend")[0].setup(device="cpu")
    mpc_j = J.mpc_examples("invpend")[0]
    mpc_j.setup()
    th = _invpend_thetas(0, 512)
    U, iters, status = NativeBatchSolver(mpc_p.engine.ldp, nu=mpc_p.model.nu).solve_batch(th)
    U_j, it_j, st_j = JNative(mpc_j.engine.ldp, nu=mpc_j.model.nu).solve_batch(th)
    assert np.all(status == 1) and np.array_equal(status, st_j)
    assert np.array_equal(iters, it_j)
    assert np.max(np.abs(U - U_j)) <= 1e-12
    sol = mpc_p.engine.solve_batch(th)
    assert np.max(np.abs(U - sol.U.numpy())) <= 1e-9


@needs_cxx
def test_native_golden():
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu", dtype=torch.float32)
    theta = mpc.form_parameter([5.0, 5.0, 0.0, 0.0], uprev=[0.0])
    U, _iters, status = NativeBatchSolver(mpc.engine.ldp).solve_batch(theta[None, :])
    assert status[0] == 1 and abs(U[0, 0] - 1.7612519326) < 1e-6


@needs_cxx
@pytest.mark.parametrize("example", ["dcmotor", "priority"])
def test_native_soft_and_priority(example):
    """Soft constraints (dcmotor) and prioritized soft rows (two levels)
    against the JAX package's runtime (1e-12) and the port's engine (1e-8)."""
    mpcs = []
    for pkg in (J, L):
        if example == "dcmotor":
            mpc = pkg.mpc_examples("dcmotor")[0]
        else:
            mpc = pkg.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=4, Nc=4)
            mpc.set_bounds(umin=[-5.0], umax=[5.0])
            mpc.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=0)
            mpc.add_constraint(Ax=[[1.0]], ub=[3.0], ks=[2, 3, 4], soft=True, prio=1)
        mpc.setup(device="cpu") if pkg is L else mpc.setup()
        mpcs.append(mpc)
    mpc_j, mpc_p = mpcs
    nth = mpc_p.engine.ldp.n_theta
    th = np.random.default_rng(3).uniform(-1, 1, (64, nth))
    U, _it, status = NativeBatchSolver(mpc_p.engine.ldp).solve_batch(th)
    U_j, _it_j, st_j = JNative(mpc_j.engine.ldp).solve_batch(th)
    assert np.all(status == 1) and np.array_equal(status, st_j)
    assert np.max(np.abs(U - U_j)) <= 1e-12
    sol = mpc_p.engine.solve_batch(th)
    assert np.max(np.abs(U - sol.U.numpy())) <= 1e-8


@needs_cxx
def test_native_rejects_wrong_width():
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
    with pytest.raises(ValueError, match="thetas must be"):
        NativeBatchSolver(mpc.engine.ldp).solve_batch(np.zeros((3, 5)))
