"""Host layers of the PyTorch port against the JAX package: condensation,
LDP lowering and the subset-inverse table, for every example plant."""

import dataclasses

import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
import linearmpc_tpu_torch as tmpc
from linearmpc_tpu.condense import mpc2mpqp as jax_mpc2mpqp
from linearmpc_tpu.ops.ldp import precompute_subset_inverses as jax_subsets
from linearmpc_tpu.ops.ldp import qp2ldp as jax_qp2ldp
from linearmpc_tpu_torch.condense import mpc2mpqp
from linearmpc_tpu_torch.ops.engine import SolverEngine
from linearmpc_tpu_torch.ops.ldp import ldp_from_numpy, precompute_subset_inverses, qp2ldp

# both packages run the same NumPy float64 host code on the same data; the
# only different arithmetic is the AD linearization (torch.func vs jax)
TOL = 1e-12


def _lowered(pkg_example, to_mpqp, to_ldp, name):
    mpc, _ = pkg_example(name)
    qp = to_mpqp(mpc)
    return qp, to_ldp(qp, soft_weight=mpc.settings.soft_weight)


def _assert_fields_close(a, b, what):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.shape == vb.shape, (what, f.name)
            if va.dtype == bool or va.dtype.kind in "iu":
                assert np.array_equal(va, vb), (what, f.name)
            else:
                scale = 1.0 + np.max(np.abs(va), initial=0.0)
                assert np.max(np.abs(va - vb), initial=0.0) <= TOL * scale, (what, f.name)
        else:
            assert va == vb, (what, f.name)


@pytest.mark.parametrize("name", lmpc.mpc_example_names())
def test_mpqp_and_ldp_match_reference(name):
    qp_j, ldp_j = _lowered(lmpc.mpc_examples, jax_mpc2mpqp, jax_qp2ldp, name)
    qp_t, ldp_t = _lowered(tmpc.mpc_examples, mpc2mpqp, qp2ldp, name)
    _assert_fields_close(qp_j, qp_t, f"{name} mpQP")
    _assert_fields_close(ldp_j, ldp_t, f"{name} LDP")
    if 0 < ldp_t.m <= 12:
        sj, st = jax_subsets(ldp_j), precompute_subset_inverses(ldp_t)
        assert np.max(np.abs(sj - st)) <= TOL * (1.0 + np.max(np.abs(sj)))


def test_example_names_match_reference():
    assert tmpc.mpc_example_names() == lmpc.mpc_example_names()


def test_ldp_from_numpy_round_trip():
    """The JAX package's LDPData carried across solves like the port's own."""
    _, ldp_j = _lowered(lmpc.mpc_examples, jax_mpc2mpqp, jax_qp2ldp, "invpend")
    _, ldp_t = _lowered(tmpc.mpc_examples, mpc2mpqp, qp2ldp, "invpend")
    carried = ldp_from_numpy(vars(ldp_j))
    for f in dataclasses.fields(ldp_j):
        assert np.array_equal(np.asarray(getattr(carried, f.name)),
                              np.asarray(getattr(ldp_j, f.name))), f.name
    rng = np.random.default_rng(5)
    thetas = np.hstack([rng.uniform(-20, 20, (32, 6)), rng.uniform(-2, 2, (32, 1))])
    sol_c = SolverEngine(carried, device="cpu").solve_batch(thetas)
    sol_t = SolverEngine(ldp_t, device="cpu").solve_batch(thetas)
    assert torch.all(sol_c.status == 1)
    assert torch.max(torch.abs(sol_c.U - sol_t.U)).item() <= 1e-10


def test_ldp_from_numpy_rejects_unknown_field():
    _, ldp_j = _lowered(lmpc.mpc_examples, jax_mpc2mpqp, jax_qp2ldp, "dcmotor")
    fields = dict(vars(ldp_j), bogus=np.zeros(1))
    with pytest.raises(ValueError, match="bogus"):
        ldp_from_numpy(fields)


def test_nonlinear_linearization_matches_reference():
    """torch.func.jacfwd against jax.jacfwd on the invpend plant."""
    mj, _ = lmpc.mpc_examples("invpend")
    mt, _ = tmpc.mpc_examples("invpend")
    for attr in ("F", "G", "C", "f_offset", "h_offset"):
        assert np.allclose(getattr(mj.model, attr), getattr(mt.model, attr),
                           rtol=0, atol=1e-14), attr
    # the Euler-wrapped true dynamics agree off the operating point
    x, u = np.array([0.1, -0.2, 0.3, 0.05]), np.array([0.4])
    fj = np.asarray(mj.model.true_dynamics(x, u, np.zeros(0)))
    ft = np.asarray(mt.model.true_dynamics(x, u, np.zeros(0)))
    assert np.max(np.abs(fj - ft)) < 1e-14
