"""K1: the bulk dual active-set phase of the small-m tier.

Replaces ``linearmpc_tpu/ops/pallas_solver.py::_iteration_kernel`` (and the
functions that loop it, ``phase1_pallas`` / ``phase1_pallas_while``) with the hand-written
CUDA kernel ``csrc/bulk.cu``: a team of threads per lane runs the whole
early-exit loop, so the fixed scan and the while-variant of the JAX package
give the same result here. The kernel is latency-bound (a few hundred flops
per iteration per lane and one dependent gather of the working-set
inverse); each thread keeps its row's state in registers, and the subset
table sits in shared memory where it is small (see the header of
``csrc/bulk.cu``).

``phase1`` keeps ``phase1_pallas``'s batch-major signature and returns.
On a CUDA tensor it launches the kernel (float32 or float64) or raises; on
a CPU tensor it runs ``phase1_plain``, the batched torch version of the
same function. The float64 instantiation is the straggler continuation of
``dual_active_set.finish_from_state``.

Sentinels: ``big`` = 3e38 in float32 (as the Pallas kernel) and 1e30 in
float64 (as the XLA loop, ``dual_active_set.py:147-153``); ``tiny`` = 1e-30.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

# kernel launches (the count a run reads to show the path went through K1)
LAUNCHES = 0

MAX_M = 10  # the tier's gate (PALLAS_MAX_M in the JAX package)


def iterate(solve, G, du_t, dl_t, eq, immut, lam, act, side, *,
            max_iter, primal_tol: float, sign_tol: float, iters0=None):
    """The batched dual active-set iteration with a per-lane freeze.

    ``solve(act, rhs) -> lam_star`` solves the working-set system of the
    running lanes (a subset-table gather or a masked factorization).
    ``eq`` is (m,) or per lane (B, m).
    ``max_iter`` is an int or a (B,) tensor of per-lane limits on
    ``iters``; ``iters0`` (B,) int32 is where each lane's count starts.
    A lane runs while it is not done and below its limit, and only its
    entered iterations count. Returns (lam, act, side, iters, done).
    """
    B, m = du_t.shape
    dev, dtype = du_t.device, du_t.dtype
    big = 3.0e38 if dtype == torch.float32 else 1.0e30
    tiny = 1e-30
    idx = torch.arange(m, device=dev)
    eq = eq.to(dev)
    immut = immut.to(dev)
    lam = lam.to(dtype).clone()
    act = act.to(torch.bool).clone()
    side = side.to(torch.bool).clone()
    iters = (torch.zeros(B, dtype=torch.int32, device=dev) if iters0 is None
             else iters0.to(device=dev, dtype=torch.int32).clone())
    limit = torch.as_tensor(max_iter, device=dev).to(torch.int32).expand(B)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        run = torch.nonzero(~done & (iters < limit)).squeeze(1)
        if run.numel() == 0:
            break
        l, a, s = lam[run], act[run], side[run]
        du, dl = du_t[run], dl_t[run]
        e = eq[run] if eq.dim() == 2 else eq
        rhs = torch.where(a, -torch.where(s, du, dl), 0.0)
        ls = solve(a, rhs)

        # multipliers of removable active rows must satisfy the side's sign
        sign_viol = a & ~e & torch.where(s, ls < -sign_tol, ls > sign_tol)
        has_viol = sign_viol.any(1, keepdim=True)

        # blocking step: the first multiplier to cross zero leaves the set
        denom = l - ls
        safe = torch.where(denom.abs() > tiny, denom, tiny)
        alpha_i = torch.where(sign_viol, l / safe, big)
        jb = alpha_i.argmin(1, keepdim=True)
        alpha = alpha_i.gather(1, jb).clamp(0.0, 1.0)
        is_jb = idx == jb
        lam_B = torch.where(is_jb, 0.0, l + alpha * (ls - l))
        act_B = a & ~is_jb

        # acceptance step: take lam*, then add the most violated row
        c = ordered_matvec(G, ls)
        cand = ~a & ~immut
        v_up = torch.where(cand, -(du + c), -big)
        v_lo = torch.where(cand, dl + c, -big)
        v = torch.maximum(v_up, v_lo)
        j = v.argmax(1, keepdim=True)
        conv = v.gather(1, j) <= primal_tol
        grow = (idx == j) & ~conv
        act_A = a | grow
        side_A = torch.where(grow, v_up.gather(1, j) >= v_lo.gather(1, j), s)
        lam_A = torch.where(act_A, ls, 0.0)

        lam[run] = torch.where(has_viol, lam_B, lam_A)
        act[run] = torch.where(has_viol, act_B, act_A)
        side[run] = torch.where(has_viol, s, side_A)
        done[run] = (~has_viol & conv).squeeze(1)
        iters[run] += 1
    return lam, act, side, iters, done


def ordered_matvec(A, x):
    """Row-batched ``x @ A.T`` for (B, r, c) or (r, c) ``A``, summed over
    ``c`` in index order, the order of the Pallas kernels' row sums."""
    acc = A[..., 0] * x[:, :1]
    for k in range(1, x.shape[1]):
        acc = acc + A[..., k] * x[:, k : k + 1]
    return acc


def mask_ids(act):
    """Subset-table index of each lane's working set: bit i is row i
    (``ldp.precompute_subset_inverses``)."""
    m = act.shape[1]
    pow2 = torch.pow(2, torch.arange(m, device=act.device, dtype=torch.int64))
    return (act.to(torch.int64) * pow2).sum(1)


def phase1_plain(subset, G, du_t, dl_t, eq, immut, lam0, act0, side0, *,
                 max_iter: int, primal_tol: float, sign_tol: float):
    """Batched torch version of K1 on any device: ``subset[mask_id]``
    gathers and row sums in the Pallas order, in the dtype of ``du_t``."""
    subset = subset.to(du_t.dtype)

    def solve(a, rhs):
        return ordered_matvec(subset[mask_ids(a)], rhs)

    return iterate(solve, G.to(du_t.dtype), du_t, dl_t, eq, immut, lam0, act0, side0,
                   max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)


def bitmask(flags) -> int:
    """A length-m sequence of flags as an int with bit i set for row i."""
    return sum(1 << i for i, f in enumerate(flags) if f)


def row_bits(flags: torch.Tensor) -> int:
    """``bitmask`` of an (m,) bool tensor on the host, kept on the tensor
    until it is modified in place: the engines pass the same mask tensors
    to every launch."""
    if flags.device.type != "cpu":
        raise ValueError("the kernels' eq/immut masks must be host tensors "
                         f"(reading them from {flags.device} would sync the device)")
    cached = getattr(flags, "_row_bits", None)
    if cached is None or cached[0] != flags._version:
        cached = (flags._version, bitmask(flags.tolist()))
        flags._row_bits = cached
    return cached[1]


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12 + [ctypes.c_int]
             + [ctypes.c_uint] * 2 + [ctypes.c_int] + [ctypes.c_double] * 2
             + [ctypes.c_void_p])


def _phase1_cuda(subset, G, du_t, dl_t, eq, immut, lam0, act0, side0, *,
                 max_iter, primal_tol, sign_tol):
    global LAUNCHES
    B, m = du_t.shape
    dtype, dev = du_t.dtype, du_t.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phase1 kernel takes float32 or float64, got {dtype}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"phase1 kernel takes 1 <= m <= {MAX_M}, got m={m}")
    if subset.shape != (2**m, m, m) or G.shape != (m, m):
        raise ValueError("subset must be (2^m, m, m) and G (m, m)")
    ins = (subset, G, du_t, dl_t, lam0, act0, side0)
    for t in ins:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"phase1 inputs must be contiguous on {dev}")
    for t in ins[:5]:
        if t.dtype != dtype:
            raise ValueError(f"subset, G, du_t, dl_t and lam0 must be {dtype}")
    for t in ins[3:]:
        if t.shape != (B, m):
            raise ValueError(f"dl_t, lam0, act0 and side0 must be ({B}, {m})")
    if act0.dtype != torch.bool or side0.dtype != torch.bool:
        raise ValueError("act0 and side0 must be bool")
    eq_bits, immut_bits = row_bits(eq), row_bits(immut)
    lam = torch.empty((B, m), dtype=dtype, device=dev)
    act = torch.empty((B, m), dtype=torch.bool, device=dev)
    side = torch.empty((B, m), dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return lam, act, side, iters, done
    fn = cuda_lib.function("bulk", "lmpc_phase1", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(0 if dtype == torch.float32 else 1, m,
                 *(t.data_ptr() for t in ins),
                 *(t.data_ptr() for t in (lam, act, side, iters, done)),
                 B, eq_bits, immut_bits, int(max_iter),
                 float(primal_tol), float(sign_tol), cuda_lib.stream(dev))
    cuda_lib.check(err, "phase1 kernel launch")
    LAUNCHES += 1
    return lam, act, side, iters, done


def phase1(subset, G, du_t, dl_t, eq, immut, lam0, act0, side0, *,
           max_iter: int, primal_tol: float, sign_tol: float):
    """Run the bulk phase; returns (lam, act, side, iters, done) batch-major.

    ``subset`` (2^m, m, m), ``G`` (m, m), ``du_t``/``dl_t``/``lam0`` (B, m)
    in one float dtype; ``act0``/``side0`` (B, m) bool; ``eq``/``immut``
    (m,) bool. On CUDA the kernel runs: every input contiguous on the card
    and ``eq``/``immut`` on the host (``row_bits``), so a launch makes no
    device sync. On the CPU the plain version does.
    """
    kw = dict(max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol)
    if du_t.device.type == "cuda":
        return _phase1_cuda(subset, G, du_t, dl_t, eq, immut, lam0, act0, side0, **kw)
    if du_t.device.type == "cpu":
        return phase1_plain(subset, G, du_t, dl_t, eq, immut, lam0, act0, side0, **kw)
    raise ValueError(f"phase1 runs on cuda or cpu tensors, got {du_t.device}")
