"""The port's multi-device layer (``linearmpc_tpu_torch/parallel``) on the
CPU with gloo: the mp-Schur row-sharded solver at (dp = 2, mp = 2) in four
processes against the JAX package's ``make_mp_batch_solver`` on four of its
eight virtual devices (``tests/test_schur_mp.py``'s problem), row padding at
mp = 4, the dp-sharded batched solve, ``SolverEngine.attach_mesh`` in a
world of one, and the two-process run of ``tests/distributed_worker.py``.

This file is also the worker: ``python tests/test_torch_parallel.py MODE
RANK WORLD PORT OUT`` joins a gloo group at ``localhost:PORT`` and writes
its results under OUT. Every multi-process test has a hard timeout."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    many tiny torch ops on every core slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _large_m(L, Nc=8):
    """``tests/test_schur_mp.py``'s problem: invpend 30/Nc with the +-18
    state box on ks 2..11 (m = 48 at Nc = 8, 47 at Nc = 7)."""
    mpc, _ = L.mpc_examples("invpend", 30, Nc)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    return mpc


def _thetas(seed, B, box):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-box, box, (B, 4)), rng.uniform(-box, box, (B, 2)),
                      rng.uniform(-2 if box > 10 else -1, 2 if box > 10 else 1, (B, 1))])


# -- the worker -------------------------------------------------------------


def _worker(mode, rank, world, port, out):
    import linearmpc_tpu_torch as L
    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
    from linearmpc_tpu_torch.parallel import make_mesh, make_sharded_batch_solver
    from linearmpc_tpu_torch.parallel.distributed import (
        initialize, make_global_mesh, shard_batch_across_hosts)
    from linearmpc_tpu_torch.parallel.schur import make_mp_batch_solver

    torch.set_num_threads(1)
    initialize(f"localhost:{port}", world, rank, device="cpu")
    save = lambda name, sol: np.savez(f"{out}/{name}_{rank}.npz",
                                      **{k: v.numpy() for k, v in sol._asdict().items()})
    if mode == "schur":
        ldp = _large_m(L).setup(device="cpu").engine.ldp
        save("dp2mp2", make_mp_batch_solver(ldp, make_mesh(2, 2, "cpu"))(_thetas(0, 32, 12.0)))
        ldp47 = _large_m(L, 7).setup(device="cpu").engine.ldp
        save("mp4", make_mp_batch_solver(ldp47, make_mesh(1, 4, "cpu"))(_thetas(1, 8, 10.0)))
        mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
        save("dp4", make_sharded_batch_solver(mpc.engine, make_mesh(4, 1, "cpu"))(
            _thetas(2, 16, 10.0)))
    else:  # the two-process run of tests/distributed_worker.py
        import torch.distributed as dist

        mesh = make_global_mesh(mp=1, device="cpu")
        assert mesh.size(0) == 2
        engine = L.mpc_examples("invpend", 50, 5)[0].setup(device="cpu").engine
        local = _thetas(1234 + rank, 8, 10.0)
        thetas = shard_batch_across_hosts(mesh, local)
        assert thetas.shape[0] == 16  # the global batch
        assert torch.equal(thetas.to_local(), torch.as_tensor(local))
        U = make_sharded_batch_solver(engine, mesh)(thetas.full_tensor()).U
        mine = U[rank * 8:(rank + 1) * 8].numpy()
        for i in range(8):
            U_ref, *_r, s = solve_ldp_numpy(engine.ldp, local[i])
            if s == 1:
                assert np.max(np.abs(mine[i] - U_ref)) < 1e-8, i
        total = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
        dist.all_gather(total, torch.tensor([8]))
        assert int(sum(total)) == 16
    print(f"worker {rank} OK", flush=True)


# -- the tests ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(mode, world, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), port, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{text}"
        assert f"worker {r} OK" in text


def _load(out, name, world):
    """Each rank's copy of a gathered solution; every rank must hold the same."""
    sols = [dict(np.load(out / f"{name}_{r}.npz")) for r in range(world)]
    for other in sols[1:]:
        for k, v in sols[0].items():
            assert np.array_equal(other[k], v), (name, k)
    return sols[0]


@pytest.fixture(scope="module")
def schur_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("schur")
    _spawn("schur", 4, out)
    return out


def test_mp_schur_matches_jax(schur_run):
    """(dp = 2, mp = 2), B = 32: the same statuses as the JAX solver on
    four virtual devices, U within 1e-8 of it where both converged, and
    within 1e-8 of the NumPy oracle on the oracle's converged lanes."""
    import jax  # noqa: F401  (set up by tests/conftest.py)
    import linearmpc_tpu as J
    from linearmpc_tpu.ops.reference_solver import solve_ldp_numpy
    from linearmpc_tpu.parallel.mesh import make_mesh as j_make_mesh
    from linearmpc_tpu.parallel.schur import make_mp_batch_solver as j_make

    sol = _load(schur_run, "dp2mp2", 4)
    mpc = _large_m(J)
    mpc.setup()
    ldp = mpc.engine.ldp
    th = _thetas(0, 32, 12.0)
    ref = j_make(ldp, j_make_mesh(dp=2, mp=2, devices=jax.devices()[:4]))(th)
    st_j, U_j = np.asarray(ref.status), np.asarray(ref.U)
    assert np.array_equal(sol["status"], st_j)
    ok = st_j == 1
    assert ok.sum() >= 16
    assert np.max(np.abs(sol["U"][ok] - U_j[ok])) <= 1e-8
    n_checked = 0
    for i in range(32):
        U_r, *_rest, s = solve_ldp_numpy(ldp, th[i])
        if s == 1:
            assert sol["status"][i] == 1, i
            assert np.max(np.abs(sol["U"][i] - U_r)) <= 1e-8, i
            n_checked += 1
    assert n_checked >= 16 and sol["active"].any()


def test_mp_schur_pads_rows(schur_run):
    """m = 47 at mp = 4: the rows are padded to 48 inside, lam comes back
    (B, m), and the converged lanes match the NumPy oracle within 1e-8."""
    import linearmpc_tpu_torch as L
    from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy

    sol = _load(schur_run, "mp4", 4)
    ldp = _large_m(L, 7).setup(device="cpu").engine.ldp
    assert ldp.m == 47 and sol["lam"].shape == (8, 47) and sol["active"].shape == (8, 47)
    th = _thetas(1, 8, 10.0)
    for i in range(8):
        U_r, *_rest, s = solve_ldp_numpy(ldp, th[i])
        if s == 1:
            assert np.max(np.abs(sol["U"][i] - U_r)) <= 1e-8, i


def test_dp_sharded_batch_solver_gathers(schur_run):
    """dp = 4 over B = 16: each rank's quarter solved and gathered equals
    the engine's own batched solve."""
    import linearmpc_tpu_torch as L

    sol = _load(schur_run, "dp4", 4)
    ref = L.mpc_examples("invpend")[0].setup(device="cpu").engine.solve_batch(
        _thetas(2, 16, 10.0))
    assert np.array_equal(sol["status"], ref.status.numpy())
    assert np.max(np.abs(sol["U"] - ref.U.numpy())) <= 1e-12


def test_two_process_distributed_solve(tmp_path):
    """``initialize``, the global mesh, the batch as a dp-sharded DTensor,
    a dp-sharded solve across the process boundary and a cross-process
    collective (``tests/distributed_worker.py`` on the port)."""
    _spawn("dist", 2, tmp_path)


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from linearmpc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, "cpu")
    yield mesh
    dist.destroy_process_group()


def test_attach_mesh_routing(world_of_one):
    """In a world of one (an in-process store): below the threshold nothing
    changes; forced, the same ``solve_batch`` runs the mp-Schur solver and
    agrees with the single-device path; a hybrid engine raises."""
    import linearmpc_tpu_torch as L
    from linearmpc_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="mesh"):
        make_mesh(2, 1, "cpu")
    e = _large_m(L).setup(device="cpu").engine
    th = _thetas(3, 16, 10.0)
    single = e.solve_batch(th)
    e.attach_mesh(world_of_one)
    assert e._mp_solver is None
    e.attach_mesh(world_of_one, force=True)
    assert e._mp_solver is not None
    sol = e.solve_batch(th)
    ok = ((sol.status == 1) & (single.status == 1)).numpy()
    assert ok.mean() > 0.8
    assert np.max(np.abs(sol.U.numpy()[ok] - single.U.numpy()[ok])) < 1e-7
    hybrid = L.mpc_examples("satellite", 6, 6)[0].setup(device="cpu").engine
    with pytest.raises(ValueError, match="branch-and-bound"):
        hybrid.attach_mesh(world_of_one)
    assert hybrid._mp_solver is None


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
