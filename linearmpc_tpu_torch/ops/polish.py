"""K2: the polish tier, a direct float64 re-solve of each lane's working set.

Replaces ``linearmpc_tpu/ops/pallas_polish.py::_polish_kernel`` (driven by
``polish_pallas``) with the hand-written CUDA kernel ``csrc/polish.cu``.
The TPU kernel works in double-single f32 (about 2^-48 relative) because
the TPU has no f64; the H100 has hardware f64, so the port computes in
native float64, which meets and beats that accuracy contract. The
double-single modules ``ops/ds.py`` and ``ops/ds_polish.py`` are therefore
not ported. A launch is the latency of one lane's short chain of f64 dot
products (O(m^2 + n(m + n + nth)) flops, run once per solve): a team of
threads runs each lane, with the static arrays (``PolishData.packed``) and
small subset tables staged in shared memory (see the header of
``csrc/polish.cu``).

``polish`` is the counterpart of ``polish_pallas``: it returns float64
``U`` (B, n), ``lam`` (B, m), ``fval`` (B,) and ``bad`` (B,), the KKT
residual of ``pallas_polish.py:241-254`` (inactive-row primal violation and
removable-row sign violation, -3e38 for a lane with neither). On a CUDA
tensor it launches the kernel or raises (every input contiguous on the
card; ``make_polish_data`` makes the statics so); on a CPU tensor it runs
``polish_plain``, the batched torch version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib
from .bulk import MAX_M, bitmask, mask_ids, ordered_matvec
from .ldp import LDPData

# kernel launches (the count a run reads to show the path went through K2)
LAUNCHES = 0

BIG = 3.0e38  # the -big of a lane with no candidate and no removable row


class PolishData(NamedTuple):
    """Static float64 inputs of the polish, on one device. The eleven float
    arrays after ``subset`` are views into ``packed``, one contiguous buffer
    that the kernel stages into shared memory in one copy."""

    subset: torch.Tensor   # (2^m, m, m) working-set inverses, bit i = row i
    G: torch.Tensor        # (m, m)
    Dth: torch.Tensor      # (m, nth)
    du: torch.Tensor       # (m,)
    dl: torch.Tensor       # (m,)
    HinvET: torch.Tensor   # (n, m)
    Uth_off: torch.Tensor  # (n, nth)
    u_off: torch.Tensor    # (n,)
    H: torch.Tensor        # (n, n)
    f: torch.Tensor        # (n,)
    f_theta: torch.Tensor  # (n, nth)
    is_eq: torch.Tensor        # (m,) bool
    is_immutable: torch.Tensor  # (m,) bool
    eq_mask: int               # is_eq as a bitmask (bit i = row i)
    immut_mask: int            # is_immutable as a bitmask
    packed: torch.Tensor       # the float arrays in the kernel's order (PACKED)


# the order of the statics in ``PolishData.packed`` (csrc/polish.cu::layout)
PACKED = ("Dth", "du", "dl", "G", "HinvET", "Uth_off", "u_off", "H", "f", "f_theta")


def make_polish_data(ldp: LDPData, subset_inv: np.ndarray, device) -> PolishData:
    arrays = {k: np.ascontiguousarray(getattr(ldp, k), dtype=np.float64) for k in PACKED}
    packed = torch.as_tensor(np.concatenate([a.ravel() for a in arrays.values()]), device=device)
    views, o = {}, 0
    for k, a in arrays.items():
        views[k] = packed[o:o + a.size].view(a.shape)
        o += a.size
    b = lambda a: torch.as_tensor(np.asarray(a, dtype=bool), device=device)
    subset = torch.as_tensor(np.ascontiguousarray(subset_inv, dtype=np.float64), device=device)
    return PolishData(subset=subset, **views, is_eq=b(ldp.is_eq),
                      is_immutable=b(ldp.is_immutable), eq_mask=bitmask(ldp.is_eq),
                      immut_mask=bitmask(ldp.is_immutable), packed=packed)


def polish_plain(pd: PolishData, thetas, act, side):
    """Batched float64 torch version of K2 on any device. Every contraction
    is summed in index order, as the kernel (and the Pallas kernel) sums,
    so the two round alike."""
    th = thetas.to(torch.float64)
    dt = ordered_matvec(pd.Dth, th)
    du = pd.du + dt
    dl = pd.dl + dt
    rhs = torch.where(act, -torch.where(side, du, dl), 0.0)
    lam = ordered_matvec(pd.subset[mask_ids(act)], rhs)
    U = (pd.u_off + ordered_matvec(pd.Uth_off, th)) - ordered_matvec(pd.HinvET, lam)
    ft = pd.f + ordered_matvec(pd.f_theta, th)
    quad = ordered_matvec(U[:, None, :], ordered_matvec(pd.H, U))[:, 0]
    lin = ordered_matvec(ft[:, None, :], U)[:, 0]
    fval = 0.5 * quad + lin
    c = ordered_matvec(pd.G, lam)
    cand = ~act & ~pd.is_immutable
    primal = torch.where(cand, torch.maximum(-(du + c), dl + c), -BIG).amax(1)
    removable = act & ~pd.is_eq
    sign = torch.where(removable, torch.where(side, -lam, lam), -BIG).amax(1)
    return U, lam, fval, torch.maximum(primal, sign)


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_uint] * 2 + [ctypes.c_void_p])


def _polish_cuda(pd: PolishData, thetas, act, side):
    global LAUNCHES
    B, m = act.shape
    n, nth = pd.Uth_off.shape
    dev = act.device
    if not 1 <= m <= MAX_M:
        raise ValueError(f"polish kernel takes 1 <= m <= {MAX_M}, got m={m}")
    if thetas.dtype != torch.float64 or thetas.shape != (B, nth):
        raise ValueError(f"thetas must be float64 ({B}, {nth})")
    if act.dtype != torch.bool or side.dtype != torch.bool or side.shape != (B, m):
        raise ValueError(f"act/side must be bool ({B}, {m})")
    ins = (pd.subset, pd.packed, thetas, act, side)
    for t in ins:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"polish inputs must be contiguous on {dev}")
    U = torch.empty((B, n), dtype=torch.float64, device=dev)
    lam = torch.empty((B, m), dtype=torch.float64, device=dev)
    fval = torch.empty(B, dtype=torch.float64, device=dev)
    bad = torch.empty(B, dtype=torch.float64, device=dev)
    if B == 0:
        return U, lam, fval, bad
    fn = cuda_lib.function("polish", "lmpc_polish", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(m, *(t.data_ptr() for t in ins),
                 *(t.data_ptr() for t in (U, lam, fval, bad)),
                 B, n, nth, pd.eq_mask, pd.immut_mask, cuda_lib.stream(dev))
    cuda_lib.check(err, "polish kernel launch")
    LAUNCHES += 1
    return U, lam, fval, bad


def polish(pd: PolishData, thetas, act, side):
    """Polish a batch from its final working sets. ``thetas`` (B, nth)
    float64, ``act``/``side`` (B, m) bool. Returns float64
    (U, lam, fval, bad)."""
    if act.device.type == "cuda":
        return _polish_cuda(pd, thetas, act, side)
    if act.device.type == "cpu":
        return polish_plain(pd, thetas, act, side)
    raise ValueError(f"polish runs on cuda or cpu tensors, got {act.device}")
