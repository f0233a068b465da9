"""linearmpc_tpu_torch: the PyTorch / CUDA port of linearmpc_tpu.

Linear Model Predictive Control on an NVIDIA GPU: condensation of
constrained tracking MPC into dense multi-parametric QPs (host NumPy),
and a batched dual active-set solver (``ops/engine.py``) with every solve
path of the JAX package's engine: the exact float64 path, the small-m,
IU and compact float32 tiers on four hand-written CUDA kernels (K1
``ops/bulk.py``, K2 ``ops/polish.py``, K3 ``ops/iu.py``, K4
``ops/ciu.py``), batched ``solve_single`` for single solves and the
float32 fallbacks, hybrid branch-and-bound (the node frontiers and the
depth-first search) and the lexicographic hierarchy. Around it: closed-loop
simulation and batched rollout, and Kalman / offset-free observers. The
offline analyses: explicit MPC (``explicit.py``: region enumeration, a
point-location BST, batched point location on the device), iteration
certification (``certify.py``) and invariant sets (``invariant.py``), on
the batched float64 interior-point LP oracle (``ops/lp_ipm.py``); LP
feasibility certificates (``ops/lp_cert.py``), state-space models
(``models/statespace.py``) and checkpoints (``checkpoint.py``).
Deployment and tooling: embedded C for the controller and the explicit
controller, and the batched ``solve_single`` saved with ``torch.export``
as one custom operator that runs the kernels (``codegen.py``); the native
C++ CPU runtime (``native_runtime.py``); solve counters, the kernels'
operation and byte models, stream overlap, profiler traces, and the
solve paths' own spans and counters, recorded while a profiler session
runs (``profiling.py``); figures (``plotting.py``, matplotlib imported only when
a figure is drawn). Multi-device: (dp, mp) device meshes, the dp-sharded
batched solve, multi-process set-up and the mp-Schur row-sharded solver on
``torch.distributed`` (``parallel/``), behind ``SolverEngine.attach_mesh``.

The package imports torch, NumPy and SciPy only, never ``jax`` or
``linearmpc_tpu``; it does all that the JAX package does.
"""

from .condense import (
    get_affine_parameter_base_dim,
    get_parameter_dims,
    get_parameter_names,
    mpc2mpqp,
)
from .models.model import (
    Labels,
    Model,
    linearize,
    make_model,
    model_from_continuous,
    model_from_nonlinear,
)
from .mpc import MPC, constraint_violation, format_move_block
from .observer import KalmanFilter, OffsetFreeObserver
from .robust import constraint_tightening
from .rollout import RolloutResult, build_rollout
from .simulation import Scenario, Simulation, get_preview, simulate, simulate_kw
from .types import (
    Constraint,
    MPCSettings,
    MPCWeights,
    MPQP,
    ParameterRange,
)
from .utils.formatting import label2id, make_subscript, prettify_parameter_label
from .utils.linalg import dare, kalman_gain, matrixify, zoh
from .explicit import ExplicitMPC, build_explicit, make_singlesided
from .certify import CertificationResult, certify
from .invariant import eliminate, invariant_set, minrep
from .models.statespace import model_from_statespace
from .checkpoint import load_explicit, load_problem, save_explicit, save_problem
from .codegen import codegen_c, codegen_c_explicit, export_compiled, load_compiled
from .profiling import SolveStats, instrument
from . import parallel

__version__ = "0.1.0"

__all__ = [
    "MPC", "Model", "Labels", "make_model", "model_from_continuous",
    "model_from_nonlinear", "linearize", "mpc2mpqp", "get_parameter_dims",
    "get_parameter_names", "get_affine_parameter_base_dim",
    "label2id", "prettify_parameter_label", "make_subscript",
    "KalmanFilter", "OffsetFreeObserver", "Scenario", "Simulation",
    "simulate", "simulate_kw", "get_preview", "Constraint", "MPCWeights",
    "MPCSettings", "MPQP", "ParameterRange", "constraint_tightening",
    "constraint_violation", "format_move_block", "dare", "kalman_gain",
    "matrixify", "zoh", "build_rollout", "RolloutResult",
    "mpc_example", "mpc_examples", "mpc_example_names",
    "ExplicitMPC", "build_explicit", "make_singlesided", "CertificationResult", "certify",
    "eliminate", "invariant_set", "minrep", "model_from_statespace",
    "load_explicit", "load_problem", "save_explicit", "save_problem",
    "codegen_c", "codegen_c_explicit", "export_compiled", "load_compiled",
    "SolveStats", "instrument", "parallel",
]


def mpc_example(name, Np=None, Nc=None, **kwargs):
    """Build a canonical example controller (reference src/mpc_examples.jl)."""
    from .models.examples import mpc_example as _ex

    return _ex(name, Np, Nc, **kwargs)


def mpc_examples(name, Np=None, Nc=None, **kwargs):
    """Return (mpc, parameter_range) for an example, mirroring the reference."""
    ex = mpc_example(name, Np, Nc, **kwargs)
    return ex.mpc, ex.range


def mpc_example_names():
    from .models.examples import mpc_example_names as _names

    return _names()
