"""The port's profiling and plotting (``linearmpc_tpu_torch/profiling.py``,
``plotting.py``) on the CPU: the ``instrument`` counters, a profiler trace,
``overlap_report``'s refusal off the card, and the figures against the JAX
package's (polygons and the certification raster within 1e-9, under
matplotlib's Agg backend, which both packages select when they draw)."""

import json

import numpy as np
import pytest
import torch

import linearmpc_tpu as J
import linearmpc_tpu_torch as L
from linearmpc_tpu import plotting as jplot
from linearmpc_tpu.explicit import build_explicit as j_build_explicit
from linearmpc_tpu.types import ParameterRange as JRange
from linearmpc_tpu_torch import plotting as pplot
from linearmpc_tpu_torch import profiling as P
from linearmpc_tpu_torch.types import ParameterRange


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    many tiny torch ops on every core slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _thetas(seed, B, box=10.0):
    rng = np.random.default_rng(seed)
    return np.hstack([rng.uniform(-box, box, (B, 4)), rng.uniform(-box, box, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_instrument_counts(dtype):
    """Two batches of 64 counted: calls, solves, converged fraction 1.0,
    iterations and a positive rate (``tests/test_codegen.py:212``)."""
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu", dtype=dtype)
    stats = P.instrument(mpc.engine)
    assert mpc.engine.stats is stats
    th = _thetas(0, 64)
    sol = mpc.engine.solve_batch(th)
    mpc.engine.solve_batch(th)
    assert stats.n_calls == 2 and stats.n_solves == 128
    assert stats.total_iters == 2 * int(sol.iters.sum())
    assert stats.max_iters == int(sol.iters.max())
    s = stats.summary()
    assert s["converged_frac"] == 1.0 and s["solves_per_s"] > 0
    assert len(stats.batch_times_s) == 2 and s["p99_batch_latency_s"] > 0


def test_trace_writes_chrome_trace(tmp_path):
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
    with P.trace(str(tmp_path / "tr")):
        mpc.engine.solve_batch(_thetas(3, 8))
    path = tmp_path / "tr" / "trace.json"
    assert path.stat().st_size > 0
    assert json.loads(path.read_text())["traceEvents"]


def test_overlap_report_needs_the_card():
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA streams"):
        P.overlap_report(mpc, B=64)


# -- plotting ------------------------------------------------------------------


def _polygons(fig):
    return [p.get_xy() for p in fig.axes[0].patches]


def test_plot_simulation_matches_jax():
    figs = []
    for pkg, plot in ((J, jplot), (L, pplot)):
        mpc = pkg.mpc_examples("invpend")[0]
        mpc.setup(device="cpu") if pkg is L else mpc.setup()
        sim = pkg.simulate_kw(mpc, x0=[0, 0, 0.15, 0], N=30, r=[0.0, 0.0])
        figs.append((plot.plot_simulation(sim), plot.plot_simulation(sim, xids=[0, 2])))
    (fj, fj2), (fp, fp2) = figs
    assert len(fp.axes) == 3 and len(fp2.axes) == 5
    for a_j, a_p in zip(fj2.axes, fp2.axes):
        for l_j, l_p in zip(a_j.lines, a_p.lines):
            assert np.max(np.abs(np.asarray(l_p.get_xydata()) - l_j.get_xydata())) <= 1e-9


def test_plot_explicit_matches_jax():
    """invpend's partition slice and feedback surface: the same polygons
    and facets as the JAX package's within 1e-9."""
    (mj, rj), (mp, rp) = J.mpc_examples("invpend"), L.mpc_examples("invpend")
    mj.setup()
    mp.setup(device="cpu")
    e_j, e_p = j_build_explicit(mj, prange=rj), L.build_explicit(mp, prange=rp)
    f_j = jplot.plot_explicit_partition(e_j, parameters=(0, 1))
    f_p = pplot.plot_explicit_partition(e_p, parameters=(0, 1))
    poly_j, poly_p = _polygons(f_j), _polygons(f_p)
    assert len(poly_p) == len(poly_j) > 0
    key = lambda p: tuple(np.round(p.mean(0), 6))
    for a, b in zip(sorted(poly_p, key=key), sorted(poly_j, key=key)):
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1e-9
    s_j = jplot.plot_explicit_feedback(e_j, parameters=(0, 1), control=0)
    s_p = pplot.plot_explicit_feedback(e_p, parameters=(0, 1), control=0)
    assert s_p.axes[0].name == "3d"
    assert len(s_p.axes[0].collections) == len(s_j.axes[0].collections) > 0


def _box(cls, mpc, s=3.0):
    rng = cls.from_mpc(mpc)
    for name in ("xmin", "rmin", "dmin", "umin", "pmin"):
        getattr(rng, name)[:] = -s
    for name in ("xmax", "rmax", "dmax", "umax", "pmax"):
        getattr(rng, name)[:] = s
    return rng


def test_plot_certification_matches_jax():
    """The iteration-count raster of invpend certified over the +-3 box
    (57 cells in both packages) equals the JAX package's."""
    mj, mp = J.mpc_examples("invpend")[0], L.mpc_examples("invpend")[0]
    mj.setup()
    mp.setup(device="cpu")
    r_j = J.certify(mj, prange=_box(JRange, mj))
    r_p = L.certify(mp, prange=_box(ParameterRange, mp))
    assert len(r_p.partition) == len(r_j.partition)
    f_j = jplot.plot_certification(r_j, resolution=40)
    f_p = pplot.plot_certification(r_p, resolution=40)
    img_j, img_p = (np.asarray(f.axes[0].collections[0].get_array()) for f in (f_j, f_p))
    assert img_p.shape == img_j.shape and np.max(np.abs(img_p - img_j)) <= 1e-9
    assert 0 < img_p.max() <= r_p.max_iterations

