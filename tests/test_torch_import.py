"""The port stands alone: it imports neither jax nor linearmpc_tpu, and its
on-card smoke test refuses to run without a GPU."""

import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _run(code_or_args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the suite's workers share few cores
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import linearmpc_tpu_torch as L\n"
        "import linearmpc_tpu_torch.ops.engine, linearmpc_tpu_torch.rollout\n"
        "mpc, _ = L.mpc_examples('invpend')\n"
        "mpc.setup(device='cpu')\n"
        "print(mpc.compute_control([5.0, 5.0, 0.0, 0.0])[0])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert abs(float(out.stdout.split()[-1]) - 1.7612519326) < 1e-6


def test_chip_smoke_fails_without_cuda():
    """No GPU here: the smoke test exits non-zero and prints no verdict."""
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the rest of the repo, it fails."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_largem_modules_leave_jax_out():
    """Every module of the large-m tiers imported and the IU tier run (its
    plain versions) without pulling in JAX."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import linearmpc_tpu_torch as L\n"
        "from linearmpc_tpu_torch.ops import ciu, compact_iu, cuda_lib, iu\n"
        "mpc, _ = L.mpc_examples('invpend', 30, 8)\n"
        "mpc.add_constraint(Ax=np.eye(4), lb=-18 * np.ones(4), ub=18 * np.ones(4),\n"
        "                   ks=range(2, 12))\n"
        "mpc.setup(device='cpu', dtype=torch.float32)\n"
        "assert mpc.engine.path == 'iu'\n"
        "print(mpc.compute_control([5.0, 5.0, 0.0, 0.0])[0])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert math.isfinite(float(out.stdout.split()[-1]))


def test_single_and_frontier_rounds_leave_jax_out():
    """Batched ``solve_single`` (the float32 m = 11 path, an infeasible
    single solve at m = 13 reporting -3) and the frontier rounds with the
    Woodbury-maintained loop on a small hybrid problem, without pulling in
    JAX."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import linearmpc_tpu_torch as L\n"
        "from linearmpc_tpu_torch.ops import bnb_frontier\n"
        "mpc, _ = L.mpc_examples('invpend', 50, 11)\n"
        "mpc.setup(device='cpu', dtype=torch.float32)\n"
        "assert mpc.engine.path == 'single'\n"
        "u = mpc.compute_control([5.0, 5.0, 0.0, 0.0])[0]\n"
        "box, _ = L.mpc_examples('invpend')\n"
        "box.add_constraint(Ax=np.eye(4), lb=-2 * np.ones(4), ub=2 * np.ones(4), ks=[2, 3])\n"
        "box.setup(device='cpu', dtype=torch.float32)\n"
        "assert box.solve(box.form_parameter(np.array([20.0, 0, 0, 0])))[2] == -3\n"
        "sat, _ = L.mpc_examples('satellite', 6, 6)\n"
        "sat.setup(device='cpu')\n"
        "fr = bnb_frontier.FrontierRounds(sat.engine.arrays, None)\n"
        "th = np.random.default_rng(0).uniform(-1, 1, (2, sat.engine.ldp.n_theta))\n"
        "assert torch.all(fr.solve(th).status == 1) and fr.rounds > 0\n"
        "print(u)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert math.isfinite(float(out.stdout.split()[-1]))


def test_hybrid_and_lex_modules_leave_jax_out():
    """The branch-and-bound and hierarchy modules imported, a float32
    hybrid control (the incremental frontier on the plain K3 step) and a
    lexicographic one computed, without pulling in JAX."""
    code = (
        "import sys\n"
        "import torch\n"
        "import linearmpc_tpu_torch as L\n"
        "from linearmpc_tpu_torch.ops import bnb, bnb_frontier, hierarchy\n"
        "mpc, _ = L.mpc_examples('satellite', 6, 6)\n"
        "mpc.setup(device='cpu', dtype=torch.float32)\n"
        "assert mpc.engine.bnb_mode == 'inc'\n"
        "u = mpc.compute_control([0.1, -0.2, 0.05], r=[0.5, 0.0, 0.0])\n"
        "lex = L.MPC.from_discrete([[1.0]], [[1.0]], C=[[1.0]], Np=3, Nc=3)\n"
        "lex.set_bounds(umin=[-5.0], umax=[5.0])\n"
        "lex.add_constraint(Ax=[[1.0]], lb=[1.0], ks=[2, 3], soft=True, prio=0)\n"
        "lex.add_constraint(Ax=[[1.0]], ub=[-1.0], ks=[2, 3], soft=True, prio=1)\n"
        "lex.settings.hierarchy = 'lexicographic'\n"
        "lex.setup(device='cpu')\n"
        "assert lex.engine.path == 'lex'\n"
        "print(lex.compute_control([0.0], r=[0.0])[0] + u[1])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert math.isfinite(float(out.stdout.split()[-1]))


def test_offline_modules_leave_jax_out():
    """The offline modules imported and invpend's explicit controller built
    (the LP oracle on the CPU) and evaluated, without pulling in JAX."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import linearmpc_tpu_torch as L\n"
        "from linearmpc_tpu_torch import certify, checkpoint, explicit, invariant\n"
        "from linearmpc_tpu_torch.models import statespace\n"
        "from linearmpc_tpu_torch.ops import lp_cert, lp_ipm\n"
        "mpc, prange = L.mpc_examples('invpend')\n"
        "mpc.setup(device='cpu')\n"
        "empc = L.build_explicit(mpc, prange=prange)\n"
        "assert len(empc.regions) == 93 and empc.stats['ipm_chunks'] > 0\n"
        "u, viol = empc.evaluate_batch(np.zeros((2, empc.nth)))\n"
        "print(empc.compute_control([5.0, 5.0, 0.0, 0.0], uprev=[0.0])[0])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert abs(float(out.stdout.split()[-1]) - 1.7612519326) < 1e-6


def test_tooling_modules_leave_jax_and_matplotlib_out():
    """The deployment, tooling and multi-device modules imported (codegen,
    native_runtime, profiling, plotting, parallel) and the package's new
    names used, without pulling in JAX, the JAX package or matplotlib (the
    machine with the card has none; plotting imports it only to draw)."""
    code = (
        "import sys, tempfile\n"
        "import linearmpc_tpu_torch as L\n"
        "assert 'matplotlib' not in sys.modules, 'the package imported matplotlib'\n"
        "from linearmpc_tpu_torch import codegen, native_runtime, plotting, profiling\n"
        "from linearmpc_tpu_torch.parallel import distributed, mesh, schur\n"
        "from linearmpc_tpu_torch.ops.engine import SolverEngine\n"
        "assert callable(SolverEngine.attach_mesh)\n"
        "for name in ('codegen_c', 'codegen_c_explicit', 'export_compiled', 'load_compiled',\n"
        "             'SolveStats', 'instrument', 'parallel'):\n"
        "    assert name in L.__all__ and hasattr(L, name), name\n"
        "mpc, _ = L.mpc_examples('invpend')\n"
        "mpc.setup(device='cpu')\n"
        "stats = L.instrument(mpc.engine)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    L.codegen_c(mpc, d)\n"
        "    meta = L.export_compiled(mpc, d + '/p.pt2', batch=4)\n"
        "print(meta['m'])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'linearmpc_tpu', 'matplotlib'))\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "5"


def test_tooling_without_cuda_needs_a_device():
    """No fallback: on a machine without CUDA the default-device paths of
    the new modules raise as ``setup()`` does (export, the mesh, the
    multi-process set-up)."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "import linearmpc_tpu_torch as L\n"
        "from linearmpc_tpu_torch.parallel import distributed, make_mesh\n"
        "def raises(fn):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as e:\n"
        "        assert 'device=\"cpu\"' in str(e), e\n"
        "        return True\n"
        "    return False\n"
        "mpc, _ = L.mpc_examples('invpend')\n"
        "assert raises(lambda: L.export_compiled(mpc, '/nonexistent/p.pt2'))\n"
        "assert raises(lambda: make_mesh(1, 1))\n"
        "assert raises(lambda: distributed.initialize('localhost:1', 2, 0))\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
