"""ctypes bridge to the native C++ batched solver (``native/batch_solver.cpp``).

Port of ``linearmpc_tpu/native_runtime.py``: the CPU-serving runtime for
machines without a card. It compiles the repository's OpenMP batched dual
active-set library with g++ (or clang++) on first use and exposes a
``NativeBatchSolver`` over the port's ``LDPData``, the same problem arrays
as the engine. The source is read, never written; the library is built
into ``linearmpc_tpu_torch/_build/``, named by a hash of the source and the
flags (``ops/cuda_lib.py``'s rule), with ``-fopenmp`` where it links. No
compiler, or a build that fails with and without OpenMP, raises.

Deliberate difference: the JAX package builds into ``native/build/`` and
keys the library by modification time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .ops.ldp import LDPData

SRC = Path(__file__).resolve().parent.parent / "native" / "batch_solver.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


class _Problem(ctypes.Structure):
    _fields_ = [
        ("m", ctypes.c_int), ("n", ctypes.c_int), ("nth", ctypes.c_int), ("nu", ctypes.c_int),
        ("G", ctypes.POINTER(ctypes.c_double)),
        ("Dth", ctypes.POINTER(ctypes.c_double)),
        ("du", ctypes.POINTER(ctypes.c_double)),
        ("dl", ctypes.POINTER(ctypes.c_double)),
        ("HinvET", ctypes.POINTER(ctypes.c_double)),
        ("Uth_off", ctypes.POINTER(ctypes.c_double)),
        ("u_off", ctypes.POINTER(ctypes.c_double)),
        ("is_eq", ctypes.POINTER(ctypes.c_int)),
        ("is_immutable", ctypes.POINTER(ctypes.c_int)),
        ("rho", ctypes.POINTER(ctypes.c_double)),
        ("iter_limit", ctypes.c_int),
        ("primal_tol", ctypes.c_double),
        ("sign_tol", ctypes.c_double),
    ]


def build_native_library(force: bool = False) -> str:
    """Compile the shared library (with OpenMP where it links) unless the
    one for this source and these flags exists; returns its path."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or clang++) for the native runtime")
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbatchsolver_{digest}.so"
    if lib.exists() and not force:
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run([*cmd, "-fopenmp"], capture_output=True, text=True)
    if proc.returncode != 0:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


class NativeBatchSolver:
    def __init__(self, ldp: LDPData, *, nu: int | None = None,
                 iter_limit: int = 1000, primal_tol: float = 1e-6,
                 sign_tol: float = 1e-12):
        self._lib = ctypes.CDLL(build_native_library())
        self._lib.lmpc_solve_batch.restype = ctypes.c_int

        as_c = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.float64))
        as_i = lambda a: np.ascontiguousarray(np.asarray(a, dtype=np.int32))
        # keep referenced arrays alive
        self._hold = [
            as_c(ldp.G), as_c(ldp.Dth), as_c(np.clip(ldp.du, -1e30, 1e30)),
            as_c(np.clip(ldp.dl, -1e30, 1e30)), as_c(ldp.HinvET), as_c(ldp.Uth_off),
            as_c(ldp.u_off), as_i(ldp.is_eq), as_i(ldp.is_immutable), as_c(ldp.rho_soft),
        ]
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        self.ldp = ldp
        self._p = _Problem(
            m=ldp.m, n=ldp.n, nth=ldp.n_theta, nu=ldp.n if nu is None else nu,
            G=dptr(self._hold[0]), Dth=dptr(self._hold[1]), du=dptr(self._hold[2]),
            dl=dptr(self._hold[3]), HinvET=dptr(self._hold[4]), Uth_off=dptr(self._hold[5]),
            u_off=dptr(self._hold[6]), is_eq=iptr(self._hold[7]),
            is_immutable=iptr(self._hold[8]), rho=dptr(self._hold[9]),
            iter_limit=iter_limit, primal_tol=primal_tol, sign_tol=sign_tol,
        )

    def solve_batch(self, thetas: np.ndarray):
        """Returns (U (B, n), iters (B,), status (B,)) as NumPy arrays."""
        thetas = np.ascontiguousarray(np.asarray(thetas, dtype=np.float64))
        if thetas.ndim != 2 or thetas.shape[1] != self.ldp.n_theta:
            raise ValueError(f"thetas must be (B, {self.ldp.n_theta}), got {thetas.shape}")
        B = thetas.shape[0]
        U = np.empty((B, self.ldp.n), dtype=np.float64)
        iters = np.empty(B, dtype=np.int32)
        status = np.empty(B, dtype=np.int32)
        self._lib.lmpc_solve_batch(
            ctypes.byref(self._p),
            thetas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            B,
            U.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return U, iters, status
