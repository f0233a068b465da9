"""K2, the polish tier: the port's float64 plain version against the JAX
package's double-single Pallas kernel (interpret mode) and its XLA twin.

The CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``), where it is held against ``polish_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linearmpc_tpu as lmpc
from linearmpc_tpu.ops.ds_polish import make_dsldp, polish_batch_ds
from linearmpc_tpu.ops.ldp import precompute_subset_inverses
from linearmpc_tpu.ops.pallas_polish import make_polish_data as jax_polish_data
from linearmpc_tpu.ops.pallas_polish import polish_pallas
from linearmpc_tpu_torch.ops import polish

# double-single carries ~2^-48 (3.6e-15) relative, the port native f64
# (~2^-53); multipliers reach |lam| ~ 1e3 here, so the two agree to ~1e-14
# relative. 1e-11 * (1 + |x|) is the JAX package's own bar between its two
# double-single versions (tests/test_ds.py:107-111), taken relative
TOL = 1e-11


def _close(a, ref):
    return np.all(np.abs(a - ref) <= TOL * (1.0 + np.abs(ref)))


# K2's team sizes: invpend (m = n = 5, 8 threads), aircraft (m = 6, n = 4,
# 8 threads), invpend 50/10 (m = n = 10, 16 threads)
CASES = {"invpend": ("invpend", None, None), "aircraft": ("aircraft", None, None),
         "invpend 50/10": ("invpend", 50, 10)}


def _solved_batch(case=CASES["invpend"], B=128, seed=7):
    mpc, prange = lmpc.mpc_examples(*case)
    mpc.setup()
    engine = mpc.engine
    lo, hi = np.asarray(prange.lower()), np.asarray(prange.upper())
    thetas = lo + (hi - lo) * np.random.default_rng(seed).uniform(0.0, 1.0, (B, len(lo)))
    sol = engine.solve_batch(jnp.asarray(thetas))  # float64 CPU path
    assert np.all(np.asarray(sol.status) == 1)
    subset_inv = precompute_subset_inverses(engine.ldp)
    return engine, subset_inv, thetas, sol


def _port(engine, subset_inv, thetas, act, side):
    pd = polish.make_polish_data(engine.ldp, subset_inv, "cpu")
    out = polish.polish(pd, torch.tensor(thetas), torch.tensor(act), torch.tensor(side))
    return [a.numpy() for a in out]


# aircraft's working-set systems are ill-conditioned (|lam| reaches ~1e10):
# against the exact f64 solve of the same working sets double-single's
# ~2^-48 carries to ~1e-3 in U and native f64 to ~3e-5. There the port is
# held to being the closer of the two, and to 1e-4 of the exact solve;
# elsewhere to TOL of both double-single versions and 1e-10 of the exact solve
ILL_CONDITIONED = {"aircraft"}


@pytest.mark.parametrize("case", list(CASES))
def test_polish_plain_matches_pallas_and_xla_ds(case):
    engine, subset_inv, thetas, sol = _solved_batch(CASES[case])
    act, side = np.asarray(sol.active), np.asarray(sol.side)
    U_t, lam_t, f_t, bad_t = _port(engine, subset_inv, thetas, act, side)
    err_t = np.max(np.abs(U_t - np.asarray(sol.U)))

    pd = jax_polish_data(engine.ldp, subset_inv)
    U_p, lam_p, f_p, bad_p = polish_pallas(pd, jnp.asarray(thetas), jnp.asarray(act),
                                           jnp.asarray(side), interpret=True)
    dsl = make_dsldp(engine.ldp, subset_inv)
    U_x, lam_x, f_x, bad_x = polish_batch_ds(dsl, jnp.asarray(thetas), jnp.asarray(act),
                                             jnp.asarray(side))
    for U_r, lam_r, f_r, bad_r in ((U_p, lam_p, f_p, bad_p), (U_x, lam_x, f_x, bad_x)):
        if case in ILL_CONDITIONED:
            assert err_t < np.max(np.abs(np.asarray(U_r.to_f64()) - np.asarray(sol.U)))
        else:
            assert _close(U_t, np.asarray(U_r.to_f64()))
            assert _close(lam_t, np.asarray(lam_r.to_f64()))
            assert _close(f_t, np.asarray(f_r.to_f64()))
        assert np.array_equal(bad_t > 1e-8, np.asarray(bad_r) > 1e-8)
    # and the exact f64 solution of the same working sets
    assert err_t < (1e-4 if case in ILL_CONDITIONED else 1e-10)
    assert np.max(bad_t) < 1e-8


def test_polish_plain_flags_corrupted_working_set():
    """As tests/test_ds.py:115-118: a flipped row must read as dirty, with
    the same flags as the Pallas kernel."""
    engine, subset_inv, thetas, sol = _solved_batch(seed=8)
    side = np.asarray(sol.side)
    wrong = np.asarray(sol.active).copy()
    wrong[:, 1] = ~wrong[:, 1]
    *_u, bad_t = _port(engine, subset_inv, thetas, wrong, side)
    pd = jax_polish_data(engine.ldp, subset_inv)
    *_p, bad_p = polish_pallas(pd, jnp.asarray(thetas), jnp.asarray(wrong), jnp.asarray(side),
                               interpret=True)
    assert np.mean(bad_t > 1e-8) > 0.5
    assert np.array_equal(bad_t > 1e-8, np.asarray(bad_p) > 1e-8)


def test_polish_bad_is_minus_big_without_candidates():
    """A lane with no candidate row and no removable row reads -big
    (pallas_polish.py:247-254): here an empty working set with every row
    immutable."""
    engine, subset_inv, thetas, _sol = _solved_batch(B=4)
    pd = polish.make_polish_data(engine.ldp, subset_inv, "cpu")
    m = engine.ldp.m
    pd = pd._replace(is_immutable=torch.ones(m, dtype=torch.bool))
    act = torch.zeros((4, m), dtype=torch.bool)
    *_u, bad = polish.polish(pd, torch.as_tensor(thetas), act, ~act)
    assert torch.all(bad == -polish.BIG)



def test_make_polish_data_packs_statics_in_kernel_order():
    """The kernel stages ``packed`` as one buffer and finds each static by
    the offsets of csrc/polish.cu::layout: the fields are views into it, in
    the order ``PACKED``, equal to the LDP's arrays."""
    engine, subset_inv, _th, _sol = _solved_batch(CASES["aircraft"], B=4)
    pd = polish.make_polish_data(engine.ldp, subset_inv, "cpu")
    o = 0
    for name in polish.PACKED:
        view = getattr(pd, name)
        ref = np.asarray(getattr(engine.ldp, name), dtype=np.float64)
        assert view.is_contiguous() and view.data_ptr() == pd.packed.data_ptr() + 8 * o
        assert np.array_equal(view.numpy(), ref)
        o += ref.size
    assert o == pd.packed.numel()
