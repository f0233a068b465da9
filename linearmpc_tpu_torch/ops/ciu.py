"""K4: the compact working-set GI bulk phase of the large-m compact tier.

Replaces ``linearmpc_tpu/ops/pallas_ciu.py::_ciu_iteration_kernel`` (and
``phase1_ciu_pallas_while``, which loops it) with the hand-written CUDA
kernel ``csrc/ciu.cu``. The iteration is ``ops/compact_iu.iterate_ciu``
(K4's plain version): the GI scheme of K3 over ``s`` working-set slots,
with the slot inverse Rw (s, s) and the slot assignment carried as an int
map ``slots`` (B, s) (row per slot, -1 free) instead of the Pallas
kernel's one-hot SEL (s*m); ``sel_from_slots`` / ``slots_from_sel``
convert. On the card kernel and plain version agree bit for bit.

``phase1_ciu`` keeps ``phase1_ciu_pallas_while``'s batch-major returns
(with ``slots`` in place of SEL): on a CUDA tensor it launches the kernel
(float32 or float64) or raises; on a CPU tensor it runs the plain version.
The float64 instantiation runs the compact tier's f64 guard and its
escalating guard ladder, at slot capacities up to m.

``ciu_max_chunk_lanes`` and ``slot_capacities`` carry over the JAX
package's VMEM-fit rule and slot-capacity selection
(``pallas_ciu.py:51-69``, ``engine.py:438-539``) as routing rules, so both
packages run the same capacities; the port has no lane chunking.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .compact_iu import init_compact, iterate_ciu
from .iu import batch_inverse, check_inputs, entry_inverse, sentinels

# kernel launches (the count a run reads to show the path went through K4)
LAUNCHES = 0

LANES = 128
# the VMEM budget of the JAX package's K4 lane rule (pallas_ciu.py:51); a
# routing constant here, not a memory limit
VMEM_BUDGET = 36 * 2**20


def ciu_max_chunk_lanes(m: int, s: int) -> int:
    """The JAX package's VMEM-fit rule for K4 at its default budget and
    lane cap (``pallas_ciu.py:51-69``): LANES where s slots fit, else 0."""
    consts = (2 * s * s * m + 3 * s**3 + m * m) * 4
    per_lane = (4 * s * m + 3 * s * s + 28 * m + 12 * s) * 4
    return LANES if (VMEM_BUDGET - consts) // per_lane >= LANES else 0


def up8(x: int) -> int:
    return ((x + 7) // 8) * 8


def slot_capacities(m: int, n: int, n_eq: int) -> tuple[int, int | None]:
    """(s_max, s2) of the compact tier, as the JAX engine picks them where
    its Pallas kernel is eligible (``engine.py:438-476``, ``:525-539``):
    n + 8 slots (at least 16 and n_eq + 8), shrunk in steps of 8 toward
    half while the VMEM-fit rule rejects them; s2, the second-chance
    capacity, is the largest multiple of 8 in (s_max, 2 s_max] the rule
    admits. s2 is None where even s_max does not fit (the JAX package then
    runs its XLA loop: no second chance)."""
    s_max = min(m, max(16, n + 8))
    s_max = max(s_max, min(m, n_eq + 8))
    s_max = min(m, up8(s_max))
    if ciu_max_chunk_lanes(m, s_max) < LANES:
        floor = min(m, max(16, up8(n_eq + 8), up8(s_max // 2)))
        cand = s_max
        while cand - 8 >= floor and ciu_max_chunk_lanes(m, cand) < LANES:
            cand -= 8
        if ciu_max_chunk_lanes(m, cand) >= LANES:
            s_max = cand
    if ciu_max_chunk_lanes(m, s_max) < LANES:
        return s_max, None
    s2 = min(m, up8(2 * s_max))
    while s2 > s_max and ciu_max_chunk_lanes(m, s2) < LANES:
        s2 -= 8
    return s_max, s2


def init_compact_batch(G_solve, act0, s_max: int):
    """Slot carry of a batch of entry working sets, (Rw (B, s, s), slots
    (B, s), ovf (B,)), in the dtype of ``G_solve`` (``pallas_ciu.py:90-110``
    with the slot map in place of SEL): ``init_compact`` of
    ``Gs = G_solve + 4 eps I``. As ``ops/iu.init_R_batch``, no Newton-Schulz
    steps (the card's Cholesky is full precision)."""
    m = G_solve.shape[0]
    eye = torch.eye(m, dtype=G_solve.dtype, device=G_solve.device)
    Gs = G_solve + 4.0 * torch.finfo(G_solve.dtype).eps * eye
    carry, ovf = init_compact(Gs, act0, s_max)
    return carry.Rw, carry.slots, ovf


def sel_from_slots(slots, m: int):
    """The Pallas kernel's one-hot assignment SEL (B, s, m) of a slot map."""
    rows = torch.arange(m, device=slots.device)
    return (slots[:, :, None] == rows) & (slots[:, :, None] >= 0)


def slots_from_sel(sel):
    """The slot map (B, s) of a one-hot SEL (B, s, m): the row each slot
    holds, -1 where it holds none."""
    sel = sel > 0.5 if sel.dtype.is_floating_point else sel.to(torch.bool)
    return torch.where(sel.any(2), sel.to(torch.int8).argmax(2), -1)


def phase1_ciu_plain(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0, *,
                     max_iter: int, primal_tol: float, sign_tol: float,
                     retry_infeas: bool = False):
    """K4's plain version on any device; returns (lam, act, side, iters,
    done, infeas, ovf, slots, Rw) batch-major, as ``phase1_ciu``."""
    Rw0 = batch_inverse(Rw0, du_t.shape[0])
    st = iterate_ciu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0,
                     max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
                     retry_infeas=retry_infeas)
    return (st.lam, st.act, st.side, st.iters, st.done, st.infeas, st.ovf,
            st.slots, st.Rw)


_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
             + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_void_p] * 10
             + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_int] + [ctypes.c_void_p])


def _phase1_ciu_cuda(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0, *,
                     max_iter, primal_tol, sign_tol, retry_infeas):
    global LAUNCHES
    B, m = du_t.shape
    s = slots0.shape[1]
    dtype, dev = du_t.dtype, du_t.device
    eq = eq.to(dev)
    check_inputs("phase1_ciu kernel", dtype, dev, B, m,
                 dict(G=(G, (m, m)), Gs=(Gs, (m, m)), dl_t=(dl_t, (B, m)),
                      lam0=(lam0, (B, m)), Rw0=(Rw0, (B, s, s))),
                 dict(act0=(act0, (B, m)), side0=(side0, (B, m)), immut=(immut, (m,)),
                      slots0=(slots0, (B, s)),
                      eq=(eq, (m,) if eq.dim() == 1 else (B, m))))
    if not 1 <= s <= m:
        raise ValueError(f"phase1_ciu kernel takes 1 <= s <= m, got s={s}, m={m}")
    big, gtol = sentinels(dtype)
    # masks go in and come out as torch.bool, one byte of 0 or 1 each, as the
    # kernel reads and writes them
    mask = lambda t: t.to(device=dev, dtype=torch.bool).contiguous()
    ins = [G.T.contiguous(), Gs.T.contiguous(), du_t.contiguous(), dl_t.contiguous(),
           mask(eq)]
    Rw0, Rw0_stride = entry_inverse(Rw0)
    ins2 = [mask(immut), lam0.contiguous(), mask(act0), mask(side0),
            slots0.to(device=dev, dtype=torch.int32).contiguous(), Rw0]
    lam = torch.empty((B, m), dtype=dtype, device=dev)
    act = torch.empty((B, m), dtype=torch.bool, device=dev)
    side = torch.empty((B, m), dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    flags = torch.empty((3, B), dtype=torch.bool, device=dev)  # done, infeas, ovf
    slots = torch.empty((B, s), dtype=torch.int32, device=dev)
    Rw = torch.empty((B, s, s), dtype=dtype, device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)
    if B > 0:
        fn = cuda_lib.function("ciu", "lmpc_ciu", _ARGTYPES)
        with torch.cuda.device(dev):
            stream = cuda_lib.stream(dev)
            err = fn(0 if dtype == torch.float32 else 1, m, s, B,
                     *(t.data_ptr() for t in ins), 0 if eq.dim() == 1 else m,
                     *(t.data_ptr() for t in ins2), Rw0_stride,
                     *(t.data_ptr() for t in (lam, act, side, iters, flags[0], flags[1],
                                              flags[2], slots, Rw, work)),
                     int(max_iter), float(primal_tol), float(sign_tol), gtol, big,
                     int(bool(retry_infeas)), stream)
        cuda_lib.check(err, "phase1_ciu kernel launch")
        LAUNCHES += 1
    return lam, act, side, iters, flags[0], flags[1], flags[2], slots.to(torch.int64), Rw


def phase1_ciu(G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0, *,
               max_iter: int, primal_tol: float, sign_tol: float,
               retry_infeas: bool = False):
    """Run the compact GI bulk phase; returns (lam, act, side, iters, done,
    infeas, ovf, slots, Rw) batch-major.

    ``G``/``Gs`` (m, m), ``du_t``/``dl_t``/``lam0`` (B, m) and ``Rw0`` (B,
    s, s), or one (s, s) entry inverse for every lane, in one float dtype;
    ``act0``/``side0`` (B, m) bool; ``slots0`` (B, s) int; ``eq`` (m,) or
    (B, m) and ``immut`` (m,) bool on any device. On CUDA the kernel runs
    (a shared entry inverse goes in once, with batch stride 0); on the CPU
    the plain version does."""
    kw = dict(max_iter=max_iter, primal_tol=primal_tol, sign_tol=sign_tol,
              retry_infeas=retry_infeas)
    Rw0 = batch_inverse(Rw0, du_t.shape[0])
    args = (G, Gs, du_t, dl_t, eq, immut, lam0, act0, side0, slots0, Rw0)
    if du_t.device.type == "cuda":
        return _phase1_ciu_cuda(*args, **kw)
    if du_t.device.type == "cpu":
        return phase1_ciu_plain(*args, **kw)
    raise ValueError(f"phase1_ciu runs on cuda or cpu tensors, got {du_t.device}")

