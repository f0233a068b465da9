"""The port's code generation and exported program against the JAX
package's (``linearmpc_tpu_torch/codegen.py`` vs ``linearmpc_tpu/codegen.py``).

Both packages emit C for the same problem; the data tables agree within
1e-12 relative (both lower the problem with the same NumPy arithmetic), the
text is the same apart from the two flag fixes the port records, and the
compiled controllers agree within 1e-10 on sampled states. The exported
program replays ``solve_single`` bit for bit on the CPU and agrees with the
JAX artifact (statuses equal, U within 1e-9)."""

import ctypes
import difflib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import linearmpc_tpu as J
import linearmpc_tpu_torch as L
from linearmpc_tpu import codegen as jcg
from linearmpc_tpu.explicit import build_explicit as j_build_explicit
from linearmpc_tpu_torch import codegen as pcg
from linearmpc_tpu_torch.ops.dual_active_set import solve_single

GOLDEN_U = 1.7612519326
CT = ctypes.c_double
needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc not available")
# the port's C differs from the JAX package's in these lines only (ROADMAP
# "Known faults in the reference": the plain solve's flag, the stalled node)
FIX_LINES = {
    "int inc_found = 0, capped = 0, top, nodes = 0, i, b, t;",
    "/* a relaxation that stalled (-1) or overflowed (-3) proves nothing:",
    "* the node is dropped and the search no longer claims optimality */",
    "if (flag == -1 || flag == -3) { capped = 1; continue; }",
    "if (flag < 0) continue;                      /* infeasible: prune */",
    "/* 1 = proven optimal; 2 = exact incumbent but the node limit, or a",
    "* node whose relaxation stalled or overflowed, stopped the proof (best",
    "* found under budget) -- same split as the batched solvers */",
    "if (inc_found) return (top > 0 || capped) ? 2 : 1;",
    "if (flag > 0) flag = 1; /* mpc_solve_ldp returns its iteration count */",
    # the JAX package's lines in their place
    "int inc_found = 0, top, nodes = 0, i, b, t;",
    "if (flag < 0) continue;                      /* infeasible/stalled: prune */",
    "/* 1 = proven optimal; 2 = exact incumbent but the node limit stopped",
    "* the search (best found under budget) -- same split as the batched",
    "* solvers */",
    "if (inc_found) return top > 0 ? 2 : 1;",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores, and
    many tiny torch ops on every core slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _observer(pkg):
    mpc, _ = pkg.mpc_examples("invpend", 50, 5)
    mpc.set_state_observer(Q=1e2 * np.array([1e-3, 1, 1e-3, 1]), R=[1, 0.1])
    return mpc


CASES = {
    "invpend": lambda pkg: pkg.mpc_examples("invpend")[0],
    "soft": lambda pkg: pkg.mpc_examples("dcmotor")[0],
    "observer": _observer,
    "hybrid": lambda pkg: pkg.mpc_examples("satellite", 10)[0],
}


def _pair(case):
    """(JAX mpc, port mpc) of a case, each set up (the port on the CPU)."""
    mpc_j, mpc_p = CASES[case](J), CASES[case](L)
    mpc_j.setup()
    return mpc_j, mpc_p.setup(device="cpu")


def _compile(cpath, so):
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", so, cpath, "-lm"], check=True)
    return ctypes.CDLL(so)


def _build(fn, mpc, d, **kw):
    return _compile(fn(mpc, str(d), **kw), f"{d}/ctrl.so")


def _cc(lib, x, r, ct=CT):
    """(flag, u) of mpc_compute_control at state x and reference r."""
    ubuf = (ct * 8)()
    arr = lambda v: (ct * len(v))(*v) if v is not None and len(v) else None
    flag = lib.mpc_compute_control(ubuf, arr(list(x)), arr(None if r is None else list(r)), None)
    return flag, np.array(ubuf[:])


_TABLE = re.compile(r"static const (\w+) (\w+)\[(\d+)\] = \{(.*?)\};", re.S)


def _split(text):
    """The emitted C as (tables by name, the text with every table cut out)."""
    tables = {}
    for ctype, name, _n, body in _TABLE.findall(text):
        vals = [v.replace("(c_float)", "") for v in body.replace("\n", "").split(",") if v]
        tables[name] = np.array([float(v) for v in vals])
    return tables, _TABLE.sub("", text)


def _assert_same_c(d_j, d_p, fname):
    """Tables within 1e-12 relative (of each table's largest entry), the
    rest of the .c and .h identical but for the fix lines and the banner."""
    for ext in ("c", "h"):
        tj, rest_j = _split(open(f"{d_j}/{fname}.{ext}").read())
        tp, rest_p = _split(open(f"{d_p}/{fname}.{ext}").read())
        assert tj.keys() == tp.keys()
        for name in tj:
            a, b = tp[name], tj[name]
            assert a.shape == b.shape, name
            scale = max(1.0, float(np.abs(b).max(initial=0.0)))
            assert np.all(np.abs(a - b) <= 1e-12 * scale), name
        diff = [ln[1:].strip() for ln in difflib.unified_diff(
            rest_j.splitlines(), rest_p.splitlines(), lineterm="", n=0)
            if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]
        diff = [ln for ln in diff if ln and "Generated by linearmpc_tpu" not in ln]
        assert set(diff) <= FIX_LINES, set(diff) - FIX_LINES


def _states(case, rng, k):
    if case == "hybrid":
        return [(rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.4, 0.4, 3)) for _ in range(k)]
    if case == "soft":
        return [(rng.uniform(-2, 2, 4), rng.uniform(-1, 1, 2)) for _ in range(k)]
    return [(rng.uniform(-10, 10, 4), rng.uniform(-10, 10, 2)) for _ in range(k)]


@pytest.mark.parametrize("case", list(CASES))
def test_emitted_c_matches_jax(case, tmp_path):
    mpc_j, mpc_p = _pair(case)
    jcg.codegen_c(mpc_j, str(tmp_path / "j"))
    pcg.codegen_c(mpc_p, str(tmp_path / "p"))
    _assert_same_c(tmp_path / "j", tmp_path / "p", "mpc_workspace")


@needs_gcc
@pytest.mark.parametrize("case", ["invpend", "soft", "hybrid"])
def test_compiled_controllers_agree(case, tmp_path):
    """Both packages' controllers within 1e-10 on sampled states; the port's
    within 1e-8 of its own engine (float64 on the CPU)."""
    mpc_j, mpc_p = _pair(case)
    lib_j = _build(jcg.codegen_c, mpc_j, tmp_path / "j")
    lib_p = _build(pcg.codegen_c, mpc_p, tmp_path / "p")
    if case == "invpend":
        flag, u = _cc(lib_p, [5.0, 5.0, 0.0, 0.0], [0.0, 0.0])
        assert flag == 1 and abs(u[0] - GOLDEN_U) < 1e-6
    nu = mpc_p.model.nu
    for x, r in _states(case, np.random.default_rng(2), 12):
        (_fj, uj), (fp, up) = _cc(lib_j, x, r), _cc(lib_p, x, r)
        assert fp >= 1
        assert np.max(np.abs(up[:nu] - uj[:nu])) <= 1e-10
        u_eng = mpc_p.compute_control(x, r=r, uprev=np.zeros(nu))
        assert np.max(np.abs(up[:nu] - u_eng[:nu])) <= (1e-6 if case == "hybrid" else 1e-8)


@needs_gcc
def test_plain_solve_returns_one(tmp_path):
    """Fault (a) of the reference: its plain controller returns the
    iteration count (2 and more), the port's 1 on every optimal solve."""
    mpc_j, mpc_p = _pair("invpend")
    lib_j = _build(jcg.codegen_c, mpc_j, tmp_path / "j")
    lib_p = _build(pcg.codegen_c, mpc_p, tmp_path / "p")
    flags_j, flags_p = [], []
    for x, r in _states("invpend", np.random.default_rng(3), 40):
        flags_j.append(_cc(lib_j, x, r)[0])
        flags_p.append(_cc(lib_p, x, r)[0])
    assert all(f == 1 for f in flags_p)
    assert max(flags_j) >= 2  # the reference's collision with B&B's "best under budget"


@needs_gcc
def test_bnb_budget_returns_two(tmp_path):
    """Fault (b) of the reference: with a cut iteration budget some node
    relaxations stall, which the reference prunes as infeasible and then
    claims 1; the port's search returns 2 there. A cut node budget gives 2
    in both."""
    mpc_j, mpc_p = _pair("hybrid")
    lib_j = _build(jcg.codegen_c, mpc_j, tmp_path / "j", iter_limit=6)
    lib_p = _build(pcg.codegen_c, mpc_p, tmp_path / "p", iter_limit=6)
    flags = [(_cc(lib_j, x, r)[0], _cc(lib_p, x, r)[0])
             for x, r in _states("hybrid", np.random.default_rng(11), 40)]
    stalled = [(fj, fp) for fj, fp in flags if fj != fp]
    assert stalled and all(fj == 1 and fp == 2 for fj, fp in stalled)
    lib_n = _build(pcg.codegen_c, mpc_p, tmp_path / "n", bnb_node_limit=16)
    for x, r in _states("hybrid", np.random.default_rng(11), 4):
        flag, u = _cc(lib_n, x, r)
        assert flag == 2
        for b in mpc_p.binary_controls:
            assert min(abs(u[b] - mpc_p.umin[b]), abs(u[b] - mpc_p.umax[b])) < 1e-6


def test_emitted_explicit_c_matches_jax(tmp_path):
    mpc_j, mpc_p = _pair("invpend")
    rng_j, rng_p = J.mpc_examples("invpend")[1], L.mpc_examples("invpend")[1]
    e_j = j_build_explicit(mpc_j, prange=rng_j)
    e_p = L.build_explicit(mpc_p, prange=rng_p)
    jcg.codegen_c_explicit(e_j, str(tmp_path / "j"))
    pcg.codegen_c_explicit(e_p, str(tmp_path / "p"))
    _assert_same_c(tmp_path / "j", tmp_path / "p", "empc_workspace")
    if shutil.which("gcc") is None:
        return
    lib = _compile(str(tmp_path / "p" / "empc_workspace.c"), str(tmp_path / "p" / "e.so"))
    flag, u = _cc(lib, [5.0, 5.0, 0.0, 0.0], [0.0, 0.0])
    assert flag == 1 and abs(u[0] - GOLDEN_U) < 1e-6
    for x, r in _states("invpend", np.random.default_rng(12), 20):
        u_py = e_p.evaluate(mpc_p.form_parameter(x, r=r, uprev=[0.0]))
        if u_py is not None:
            assert abs(_cc(lib, x, r)[1][0] - u_py[0]) < 1e-8


@needs_gcc
def test_codegen_settings_passthrough(tmp_path):
    """``settings.solver_opts`` reach the emitted defines and change the
    embedded solver: a huge primal_tol accepts the unconstrained iterate."""
    mpc, _ = L.mpc_examples("invpend")
    mpc.settings.solver_opts["primal_tol"] = 50.0
    mpc.settings.solver_opts["iter_limit"] = 7
    mpc.setup(device="cpu")
    cpath = pcg.codegen_c(mpc, str(tmp_path / "loose"))
    text = open(cpath.replace(".c", ".h")).read()
    assert "#define MPC_PRIMAL_TOL 50" in text
    assert "#define MPC_ITER_LIMIT 7" in text
    u_loose = _cc(_compile(cpath, f"{tmp_path}/loose.so"), [5.0, 5.0, 0.0, 0.0], [0.0, 0.0])[1]
    mpc2 = L.mpc_examples("invpend")[0].setup(device="cpu")
    u_tight = _cc(_build(pcg.codegen_c, mpc2, tmp_path / "tight"), [5.0, 5.0, 0.0, 0.0],
                  [0.0, 0.0])[1]
    assert abs(u_tight[0] - GOLDEN_U) < 1e-6
    assert abs(u_loose[0] - u_tight[0]) > 1e-3


@needs_gcc
def test_codegen_single_precision(tmp_path):
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
    cpath = pcg.codegen_c(mpc, str(tmp_path), float_type="single")
    flag, u = _cc(_compile(cpath, f"{tmp_path}/c32.so"), [5.0, 5.0, 0.0, 0.0], [0.0, 0.0],
                  ct=ctypes.c_float)
    assert flag == 1 and abs(u[0] - GOLDEN_U) < 1e-3  # single precision


@needs_gcc
def test_codegen_observer_matches_port(tmp_path):
    mpc = _observer(L).setup(device="cpu")
    lib = _build(pcg.codegen_c, mpc, tmp_path)
    rng = np.random.default_rng(4)
    x, u, y = rng.standard_normal(4), rng.standard_normal(1), np.zeros(2)
    mpc.set_state(x)
    x1 = mpc.state_observer.predict(u).copy()
    x2 = mpc.state_observer.correct(y).copy()
    xc = (CT * 4)(*x)
    lib.mpc_predict_state(xc, (CT * 1)(*u), None)
    assert np.linalg.norm(np.array(xc[:]) - x1) < 1e-9
    lib.mpc_correct_state(xc, (CT * 2)(*y), None)
    assert np.linalg.norm(np.array(xc[:]) - x2) < 1e-9


@needs_gcc
def test_codegen_warm_start(tmp_path):
    """The warm-started C gives the same control in fewer iterations on the
    repeated call, matches the port nearby, and resets."""
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
    lib = _build(pcg.codegen_c, mpc, tmp_path, warm_start=True)
    x, r = [5.0, 5.0, 0.0, 0.0], [0.0, 0.0]
    u_cold = _cc(lib, x, r)[1]
    it_cold = lib.mpc_last_iterations()
    assert abs(u_cold[0] - GOLDEN_U) < 1e-6
    flag, u_warm = _cc(lib, x, r)
    assert flag == 1 and abs(u_warm[0] - u_cold[0]) < 1e-12
    assert lib.mpc_last_iterations() < it_cold
    rng = np.random.default_rng(5)
    for _ in range(10):
        xk = np.asarray(x) + rng.uniform(-0.5, 0.5, 4)
        u_py = mpc.compute_control(xk, r=r, uprev=[0.0])
        assert abs(u_py[0] - _cc(lib, xk, r)[1][0]) < 1e-8
    lib.mpc_reset_warmstart()
    assert abs(_cc(lib, x, r)[1][0] - u_cold[0]) < 1e-12
    assert lib.mpc_last_iterations() == it_cold


@needs_gcc
def test_codegen_closed_loop_uprev(tmp_path):
    """A closed loop in C with mpc_set_uprev between steps matches the port's
    Python loop, which threads uprev."""
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu")
    lib = _build(pcg.codegen_c, mpc, tmp_path, warm_start=True)
    x = np.array([2.0, 1.0, 0.0, 0.0])
    x_py, uprev = x.copy(), np.zeros(1)
    for _ in range(25):
        u_py = mpc.compute_control(x_py, r=[0.0, 0.0])
        lib.mpc_set_uprev((CT * 1)(*uprev))
        u_c = _cc(lib, x, [0.0, 0.0])[1]
        assert abs(u_py[0] - u_c[0]) < 1e-8
        uprev = np.array([u_c[0]])
        x = mpc.model.F @ x + mpc.model.G @ uprev
        x_py = mpc.model.F @ x_py + mpc.model.G @ np.atleast_1d(u_py)


@needs_gcc
def test_codegen_reference_preview_full(tmp_path):
    """Full (uncondensed) reference preview in C matches the port."""
    mpc = L.MPC.from_discrete(np.array([[1.0, 1], [0, 1]]), np.array([[0.0], [1]]),
                              C=np.eye(2), Np=5, Nc=3)
    mpc.set_bounds(umin=[-2.0], umax=[2.0])
    mpc.set_objective(Q=[1.0, 1.0], R=[0.1])
    mpc.settings.reference_preview = True
    mpc.setup(device="cpu")
    r_traj = np.array([[0.0, 0.5, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    x = np.array([1.0, 0.0])
    u_py = mpc.compute_control(x, r=r_traj)
    lib = _build(pcg.codegen_c, mpc, tmp_path)
    u = (CT * 1)()
    r_flat = np.asarray(r_traj.T.ravel(), dtype=np.float64)  # column-major trajectory
    assert lib.mpc_compute_control(u, (CT * 2)(*x), (CT * len(r_flat))(*r_flat), None) == 1
    assert abs(u[0] - u_py[0]) < 1e-8


# -- the exported program ----------------------------------------------------


def _largem(pkg):
    mpc, _ = pkg.mpc_examples("invpend", 50, 8)
    mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4), ks=range(2, 12))
    return mpc


def _thetas(rng, B, box):
    return np.hstack([rng.uniform(-box, box, (B, 4)), rng.uniform(-box, box, (B, 2)),
                      rng.uniform(-2, 2, (B, 1))])


def test_export_replays_solve_single_bit_for_bit(tmp_path):
    """``export_compiled`` -> ``load_compiled`` at B = 32 on the CPU: the
    outputs equal a direct batched ``solve_single`` call bit for bit (float32
    engine: the bulk phase and the float64 continuation)."""
    mpc = L.mpc_examples("invpend")[0].setup(device="cpu", dtype=torch.float32)
    path = str(tmp_path / "invpend.pt2")
    meta = pcg.export_compiled(mpc, path, batch=32)
    assert meta == {"batch": 32, "n_theta": 7, "n": 5, "m": 5, "dtype": "float32",
                    "platform": "cpu"}
    fn = pcg.load_compiled(path)
    th = torch.as_tensor(_thetas(np.random.default_rng(0), 32, 20.0))
    U, iters, status = fn(th)
    sol = solve_single(mpc.engine.arrays, th, **mpc.engine._single_kw)
    assert torch.equal(U, sol.U) and torch.equal(iters, sol.iters)
    assert torch.equal(status, sol.status)
    theta = mpc.form_parameter([5.0, 5.0, 0.0, 0.0], uprev=[0.0])
    U1, _it, st1 = fn(torch.as_tensor(np.tile(theta, (32, 1))))
    assert bool((st1 == 1).all()) and abs(float(U1[0, 0]) - GOLDEN_U) < 1e-6


@pytest.mark.parametrize("case", ["invpend", "m48"])
def test_export_matches_jax_artifact(case, tmp_path):
    """The port's artifact (float32 engine: K1's or K3's route, then the
    float64 continuation) against the JAX package's (float64 on its CPU) on
    the same theta: statuses equal, U within 1e-9."""
    B = 32
    if case == "invpend":
        mpc_j, mpc_p, th = J.mpc_examples("invpend")[0], L.mpc_examples("invpend")[0], 20.0
    else:
        mpc_j, mpc_p, th = _largem(J), _largem(L), 12.0
    mpc_j.setup()
    mpc_p.setup(device="cpu", dtype=torch.float32)
    assert case == "invpend" or mpc_p.engine._single_kw["bulk_inverse_updates"]
    jcg.export_compiled(mpc_j, str(tmp_path / "j.jaxexport"), batch=B)
    pcg.export_compiled(mpc_p, str(tmp_path / "p.pt2"), batch=B)
    thetas = _thetas(np.random.default_rng(1), B, th)
    U_j, _it_j, st_j = jcg.load_compiled(str(tmp_path / "j.jaxexport"))(thetas)
    U_p, _it_p, st_p = pcg.load_compiled(str(tmp_path / "p.pt2"))(torch.as_tensor(thetas))
    st_j = np.asarray(st_j)
    assert np.array_equal(st_p.numpy(), st_j)
    ok = st_j == 1
    assert ok.any()
    assert np.max(np.abs(U_p.numpy()[ok] - np.asarray(U_j)[ok])) <= 1e-9


def test_export_refuses_hybrid(tmp_path):
    mpc = L.mpc_examples("satellite", 6, 6)[0].setup(device="cpu")
    with pytest.raises(ValueError, match="solve_single"):
        pcg.export_compiled(mpc, str(tmp_path / "h.pt2"), batch=4)
