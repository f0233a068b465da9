"""Iteration-complexity certification in the port
(``linearmpc_tpu_torch/certify.py``) against the JAX package's, on the
CPU (``device="cpu"``): invpend over the +-6 box of
``tests/test_certify.py::_small_range``, each package certified once for
the module. Parity is the partition: its size, its (active set,
iteration count) cells and the worst case, not the LP iterates.
"""

import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.types import ParameterRange as JRange
from linearmpc_tpu_torch.ops.reference_solver import solve_ldp_numpy
from linearmpc_tpu_torch.types import ParameterRange


def _small_range(cls, mpc, scale=6.0):
    rng = cls.from_mpc(mpc)
    for name in ("xmin", "rmin", "dmin", "umin", "pmin"):
        getattr(rng, name)[:] = -scale
    for name in ("xmax", "rmax", "dmax", "umax", "pmax"):
        getattr(rng, name)[:] = scale
    return rng


@pytest.fixture(scope="module")
def certified():
    """(JAX result, port result, port controller, box)."""
    mj, _ = lmpc.mpc_examples("invpend")
    mj.setup()
    res_j = lmpc.certify(mj, prange=_small_range(JRange, mj))
    mt, _ = tmpc.mpc_examples("invpend")
    mt.setup(device="cpu")
    box = _small_range(ParameterRange, mt)
    return res_j, tmpc.certify(mt, prange=box), mt, box


def test_partition_matches_jax(certified):
    """781 cells and a worst case of 10 iterations in both packages, not
    exhausted; the cells' (active set, iterations) agree as multisets."""
    res_j, res_t, _mpc, _box = certified
    assert not res_t.exhausted and not res_j.exhausted
    assert len(res_t.partition) == len(res_j.partition) == 781
    assert res_t.max_iterations == res_j.max_iterations == 10
    cells = lambda res: sorted((c.active_set, c.iterations) for c in res.partition)
    assert cells(res_t) == cells(res_j)
    assert res_t.stats["ipm_chunks"] > 0 and res_t.stats["highs"] > 0


def test_certified_bound_holds_on_samples(certified):
    """The certified worst case dominates the port's NumPy oracle's
    iteration counts on 300 samples of the box."""
    _res_j, res_t, mpc, box = certified
    lb, ub = box.lower(), box.upper()
    rng = np.random.default_rng(11)
    worst = 0
    for _ in range(300):
        theta = lb + (ub - lb) * rng.random(len(lb))
        _, _, _, it, status = solve_ldp_numpy(mpc.engine.ldp, theta)
        if status == 1:
            worst = max(worst, it)
    assert 0 < worst <= res_t.max_iterations


def test_cells_hold_their_centers(certified):
    """Each cell's interior point lies inside its cell and the box."""
    _res_j, res_t, _mpc, box = certified
    lb, ub = box.lower(), box.upper()
    for cell in res_t.partition:
        assert np.all(cell.center >= lb - 1e-9) and np.all(cell.center <= ub + 1e-9)
        if len(cell.bth):
            assert np.max(cell.Ath @ cell.center - cell.bth) <= 1e-9


def test_certify_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mpc, _ = tmpc.mpc_examples("invpend")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmpc.certify(mpc, prange=_small_range(ParameterRange, mpc, 1.0))
