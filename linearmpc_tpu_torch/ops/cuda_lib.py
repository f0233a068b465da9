"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` into a shared library, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build happens on first use, keyed by a hash
of the source, the shared ``csrc/*.cuh`` headers and the flags, into
``linearmpc_tpu_torch/_build/``; a failed build raises. ``build_all``
compiles several sources at once, one ``nvcc`` each. ``function`` hands out
an entry point with its argument types set once, so a launch pays only for
the call. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so each kernel rounds operation
# for operation like its plain torch version (and the Pallas kernels), and
# the two agree bit for bit where they sum in the same order
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
BUILD_SECONDS: dict[str, float] = {}
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it first
    if no library for this exact source exists yet."""
    if name in _LIBS:
        return _LIBS[name]
    src = SRC_DIR / f"{name}.cu"
    # the shared headers are part of every source
    text = b"".join(p.read_bytes() for p in [src, *sorted(SRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = proc.stderr
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, returning a
    ``cudaError_t`` as int, with its argument types set on first use."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA ``device``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def build_all(names) -> None:
    """Build and load several kernels at once, one ``nvcc`` process each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for fut in [ex.submit(load, n) for n in names]:
            fut.result()


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
